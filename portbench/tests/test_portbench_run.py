"""A run of each cell on the CPU, at a size a test holds, with the card's
look skipped: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false.  And the command itself, on a
machine without a card: it finds every file and draws the traffic, then
refuses to measure."""

import subprocess
import sys
import time

import pytest
import torch

from portbench import run
from portbench.harness import program, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
# a size a test holds, by configuration; the wide one at a sixth of its
# own, where its 121-tap window still leaves dense edges
SIZES = {"cam1080": (120, 200), "uhd4k": (144, 256),
         "cam1080wide": (180, 320)}


def run_cell(name, *, wrap=None, trace=False, seconds=0.6, seed=2**33 + 5):
    cell, driver, plan, readers = run.prepare(name, seed, trace)
    h, w = SIZES[cell.config["name"]]
    c = cell.config
    cell.config = dict(c, height=h, width=w,
                       scene_width=w * c["scene_width"] // c["width"])
    cell.traffic = dict(cell.traffic, pool_bytes=16 * h * w,
                        sample_pixels=16 * h * w,
                        trace_max_s=seconds)
    plan = driver.plan(cell.config, cell.traffic, seed)
    return run.measure(cell, driver, plan, readers, seconds=seconds,
                       trace=trace, device=torch.device("cpu"),
                       make_model=program.make_model,
                       t_start=time.perf_counter(), wrap=wrap)


class Fault:
    """The model with a fault under both entry points."""

    def __init__(self, model, kind):
        self.model, self.kind, self.first = model, kind, None

    def _broken(self, fn, x, lo, hi):
        if self.kind == "half_batch":
            keep = x.shape[0] // 2
            out = fn(x[:keep], lo, hi)
            return torch.cat([out, torch.zeros_like(out[:1]).expand(
                x.shape[0] - keep, *out.shape[1:])])
        out = fn(x, lo, hi)
        if self.kind == "altered":          # an answer altered where made
            out[..., 0, 0] ^= 255
            return out
        if self.first is None:              # "stale": state left unchanged
            self.first = out
        return self.first.clone()

    def __call__(self, x, lo, hi):
        return self._broken(self.model, x, lo, hi)

    def batch(self, x, lo, hi):
        return self._broken(self.model.batch, x, lo, hi)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_cell(cell)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["frames_checked"]["value"] >= \
        spec.resolve(cell).traffic["batch"]
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]
    assert res["device"]["platform"] == "cpu"


FAULTS = [(c, k) for c in CELLS for k in ("altered", "stale")] + \
    [(c, "half_batch") for c in CELLS if "batch" in c]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_fault_is_not_correct(cell, kind):
    # a window long enough for several requests on a loaded CPU: a stale
    # answer shows only once a second frame is answered
    res = run_cell(cell, wrap=lambda m: Fault(m, kind), seconds=2.0)
    assert res["info"]["requests"] >= 2
    assert res["correct"] is False, (kind, res["checks"])
    assert res["checks"]["mismatched_px"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    """The traced slice on the CPU: host spans and a breakdown; the device
    metrics find nothing to read and are left out, never 0."""
    res = run_cell(cell, trace=True, seconds=2.0)
    assert res["correct"] is True
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    assert res["breakdown"]["device_ops"] == []
    labels = {k for k, _ in res["breakdown"]["idle_gaps"]}
    assert "call" in labels
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.resolve(cell).per_layer
                                   if m["source"] == "host_clock"}


@pytest.mark.parametrize("cell", CELLS)
def test_command_refuses_without_a_card(cell, no_card):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**40 + 3), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2
    assert "no CUDA device" in p.stderr
    assert p.stdout.strip() == ""


def test_reservoir_keeps_a_uniform_sample():
    from portbench.harness.check import Reservoir

    hits = [0] * 20
    for seed in range(400):
        r = Reservoir(4, seed)
        for i in range(20):
            r.offer(i, None)
        for i, _ in r.items:
            hits[i] += 1
    assert sum(hits) == 1600
    assert min(hits) > 40 and max(hits) < 120      # 80 each, expected


def test_jax_loaded_after_the_window_refuses(monkeypatch):
    """A run in whose process JAX (or the JAX package) is loaded once the
    window has closed exits 3 and prints no result."""
    import types

    monkeypatch.setitem(sys.modules, "canny_edge_tpu",
                        types.ModuleType("canny_edge_tpu"))
    with pytest.raises(SystemExit) as e:
        run_cell(CELLS[0], seconds=0.2)
    assert e.value.code == 3


def test_reap_ends_a_child_left_running():
    """The last guard before the result: a child that something left
    running is ended and waited for."""
    from portbench.harness.procs import children, reap

    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        assert [pid for pid, _ in children()] == [child.pid]
        assert [pid for pid, _ in reap(grace_s=5.0)] == [child.pid]
        assert children() == []
    finally:
        child.kill()
        child.wait()
