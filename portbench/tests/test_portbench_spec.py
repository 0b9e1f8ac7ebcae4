"""``BENCHMARK.json`` against the contract the benchmark is held to, and
every cell resolved to its files by name."""

import json
import math
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.driver_path.is_file()
    mod = spec.load_driver(c)
    assert callable(mod.plan) and hasattr(mod, "Workload")
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_metric(m["name"]).read)


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME_RE.match(n), n
    for m in METRICS:
        assert UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES
        assert ONE_LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(spec.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        assert ONE_LINE.match(c["why"]) and ONE_LINE.match(c["source"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert ONE_LINE.match(w["why"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e, layer = spec.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


def test_per_layer_metrics_list_their_cells():
    """A per-layer metric belongs to the cells it lists, and to no other."""
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in CELLS:
            listed = cell in m["workloads"]
            assert listed == (m in spec.cell_metrics(BENCH, cell)[1])


def test_a_split_quantity_has_one_reader():
    """``<quantity>.<part>`` is read by the quantity's file."""
    assert spec.metric_path("device_idle_pct.live") == \
        spec.metric_path("device_idle_pct")
    with pytest.raises(FileNotFoundError):
        spec.metric_path("no_such_quantity.part")


def test_moves_targets_are_reported():
    """Every cell that lists a per-layer metric reports the end-to-end
    metric that metric moves."""
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e_names
        for cell in m["workloads"]:
            assert cell in CELLS
            reported = {x["name"] for x in spec.cell_metrics(BENCH, cell)[0]}
            assert m["moves"] in reported, (m["name"], cell)


def test_one_layer_one_name():
    """Metrics of one layer give it letter for letter alike."""
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_run_seconds_fits_a_full_check():
    """The whole check of 24 cells fits 43200 seconds."""
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_traffic_files_name_their_driver():
    for w in BENCH["workloads"]:
        t = spec.load_traffic(w["traffic"])
        assert spec.driver_path(t["driver"]).is_file()
        assert math.isfinite(t["pool_bytes"]) and t["pool_bytes"] >= 4 * 52428800  # the H100 L2
