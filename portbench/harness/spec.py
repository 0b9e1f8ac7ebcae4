"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[]``) names a configuration and a traffic mix.  Each
piece is a file of its own, so a later cell, mix, driver or metric is a new
file and never an edit:

* the configuration: ``configs[].file`` (a JSON object of sizes; its
  frames' type is ``dtype``, ``"uint8"`` where the key is absent, or
  ``"uint16"``, and ``full_scale`` the scene's white level, 255 where
  absent: :func:`frame_type`);
* the traffic mix: ``portbench/traffic/<traffic>.json``, which names its
  driver, ``portbench/drivers/<driver>.py``;
* each metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` gives
  its value or None.  A name ``<quantity>.<part>`` is one quantity split by
  cells (each part moves the end-to-end metric its own cells report) and is
  read by ``portbench/metrics/<quantity>.py``.

A per-layer metric belongs to the cells its ``workloads`` lists; an
end-to-end metric to those, or without that key to every cell.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
# a frame type a configuration may state, and its largest value
FRAME_TYPES = {"uint8": 255, "uint16": 65535}


@dataclass
class Cell:
    """One workload with everything it resolves to."""
    name: str
    chips: int
    config: dict
    traffic: dict
    driver_path: Path
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def frame_type(config: dict) -> tuple[str, int]:
    """``(dtype, full_scale)`` of a configuration's frames; ``ValueError``,
    saying why, for a type not in :data:`FRAME_TYPES` or a white level that
    is not a whole number from 1 to the type's largest value."""
    dtype = config.get("dtype", "uint8")
    if dtype not in FRAME_TYPES:
        raise ValueError(f"configuration {config.get('name')!r}: dtype "
                         f"{dtype!r} is not one of {sorted(FRAME_TYPES)}")
    full = config.get("full_scale", 255)
    top = FRAME_TYPES[dtype]
    if isinstance(full, bool) or not isinstance(full, int) \
            or not 1 <= full <= top:
        raise ValueError(f"configuration {config.get('name')!r}: full_scale "
                         f"{full!r} is not a whole number from 1 to {top}, "
                         f"the largest {dtype} value")
    return dtype, full


def frame_itemsize(config: dict) -> int:
    """Bytes a pixel of the configuration's frames."""
    return np.dtype(frame_type(config)[0]).itemsize


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """``(end-to-end, per-layer)`` metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; ``KeyError`` if there is
    none, ``FileNotFoundError`` if a file it names is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    frame_type(config)
    traffic = load_traffic(w["traffic"], root)
    e2e, layer = cell_metrics(bench, name)
    for m in e2e + layer:
        metric_path(m["name"], root)
    return Cell(name, w["chips"], config, traffic,
                driver_path(traffic["driver"], root), e2e, layer)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    path = root / "portbench" / "traffic" / f"{name}.json"
    with open(path) as f:
        traffic = json.load(f)
    driver_path(traffic["driver"], root)
    return traffic


def _existing(path: Path) -> Path:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return path


def driver_path(name: str, root: Path = ROOT) -> Path:
    return _existing(root / "portbench" / "drivers" / f"{name}.py")


def metric_path(name: str, root: Path = ROOT) -> Path:
    quantity = name.split(".", 1)[0]
    return _existing(root / "portbench" / "metrics" / f"{quantity}.py")


def load_module(path: Path, prefix: str):
    """The module in ``path``, under a name of its own."""
    mod_name = f"portbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: Path = ROOT):
    return load_module(metric_path(name, root), "metric")


def load_driver(cell: Cell):
    return load_module(cell.driver_path, "driver")
