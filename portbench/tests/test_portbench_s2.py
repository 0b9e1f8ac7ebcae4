"""The Sentinel-2 cell ``s2l1c.tiles2`` on the CPU, at a size a test holds:
its configuration states 16-bit frames at a white level of 10000; a run
through the program (``CannyTorch(backend="fused")``, which takes uint16
frames) comes out correct and judges a frame; an answer altered where it
is made, or the control's taps (bfloat16), comes out not correct."""

import time

import numpy as np
import torch

from portbench import run
from portbench.harness import program, spec
from portbench.reference import oracle

CELL = "s2l1c.tiles2"
# a sixtieth of the tile's side, then a frame of the scene's aspect; the
# scene keeps its pixel scale (scene width = width)
SIZE = (180, 320)


class Altered:
    """The model with one pixel of every answer flipped where it is
    made."""

    def __init__(self, model):
        self.model = model

    def __call__(self, x, lo, hi):
        out = self.model(x, lo, hi)
        out[..., 7, 9] ^= 255
        return out


def run_cell(*, make_model=program.make_model, wrap=None, seconds=1.0,
             seed=2**33 + 11):
    cell, driver, plan, readers = run.prepare(CELL, seed, False)
    h, w = SIZE
    c = cell.config
    cell.config = dict(c, height=h, width=w,
                       scene_width=w * c["scene_width"] // c["width"])
    cell.traffic = dict(cell.traffic, pool_bytes=4 * h * w * 2,
                        sample_pixels=2 * h * w)
    plan = driver.plan(cell.config, cell.traffic, seed)
    return run.measure(cell, driver, plan, readers, seconds=seconds,
                       trace=False, device=torch.device("cpu"),
                       make_model=make_model, t_start=time.perf_counter(),
                       wrap=wrap)


def test_configuration_states_16_bit_frames():
    cell = spec.resolve(CELL)
    assert spec.frame_type(cell.config) == ("uint16", 10000)
    assert spec.frame_itemsize(cell.config) == 2
    c = cell.config
    assert (c["height"], c["width"], c["scene_width"]) == (10980,) * 3
    assert (c["min_val"], c["max_val"]) == (round(30 * 10000 / 255),
                                            round(90 * 10000 / 255))
    assert len(oracle.gaussian_kernel(c["sigma"])) == 11
    assert cell.traffic["pool_bytes"] == 4 * 10980 * 10980 * 2
    assert cell.traffic["sample_pixels"] == 10980 * 10980
    assert {m["name"] for m in cell.per_layer} == {
        "k1_roofline.tile", "k2_roofline.tile", "device_idle_pct.tile",
        "entry_host_ms.tile"}


def test_sound_run_is_correct():
    res = run_cell()
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["frames_checked"]["value"] >= 1
    assert res["info"]["pool_bytes"] == 4 * SIZE[0] * SIZE[1] * 2
    assert {"mpix_per_s", "setup_s"} <= set(res["metrics"])


def test_altered_answer_is_not_correct():
    res = run_cell(wrap=Altered)
    assert res["correct"] is False
    assert res["checks"]["mismatched_px"]["value"] > 0


def test_controls_taps_are_not_correct():
    """The control (``harness/program.py:make_control_model``: the float32
    taps rounded to bfloat16) on the program's own path; at this seed and
    size its taps change the map, which the oracle shows first."""
    seed = 2**33 + 11
    res = run_cell(make_model=program.make_control_model, seed=seed)
    assert res["correct"] is False
    assert res["checks"]["mismatched_px"]["value"] > 0
    taps = torch.from_numpy(oracle.gaussian_kernel(1.4))
    assert not np.array_equal(taps.to(torch.bfloat16).float().numpy(),
                              taps.numpy())
