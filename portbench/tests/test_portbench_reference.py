"""The frozen oracle and the frame generator, on the CPU at small sizes:
the oracle gives the port's plain CPU path's edges for both
configurations' sigmas, and the control (taps rounded to bfloat16) does
not."""

import json

import numpy as np
import pytest
import torch

from canny_edge_tpu_torch import CannyTorch, golden
from portbench.harness import program
from portbench.harness.spec import ROOT
from portbench.reference import frames
from portbench.reference.compare import judge, judge_all, oracle_edges


def config(name, h, w):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return dict(json.load(f), height=h, width=w)


def pool(n, h, w, seed, scene_width=None):
    params = frames.frame_params(n, h, w, seed)
    return frames.make_pool(params, h, w, seed, torch.device("cpu"),
                            scene_width or w)


def test_frames_depend_on_the_seed_only():
    a, b = pool(3, 40, 64, 2**40 + 7), pool(3, 40, 64, 2**40 + 7)
    c = pool(3, 40, 64, 2**40 + 8)
    assert a.dtype == torch.uint8 and a.shape == (3, 40, 64)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    assert frames.frame_params(5, 40, 64, -3).shape == (5, 5)


def test_a_wider_frame_is_the_scene_scaled():
    """At twice the scene width each scene pixel's noise covers a 2 x 2
    block: neighbours within a block differ far less than across one."""
    x = pool(2, 64, 128, 2**35 + 3, scene_width=64).to(torch.int32)
    within = (x[:, :, 0::2] - x[:, :, 1::2]).abs().float().mean()
    across = (x[:, :, 1:-1:2] - x[:, :, 2::2]).abs().float().mean()
    assert within * 3 < across
    rows_within = (x[:, 0::2] - x[:, 1::2]).abs().float().mean()
    assert rows_within * 3 < across


@pytest.mark.parametrize("name", ["cam1080", "uhd4k"])
def test_oracle_is_the_ports_plain_path(name):
    c = config(name, 150, 240)
    model = CannyTorch(sigma=c["sigma"], device="cpu", backend=c["backend"],
                       hysteresis_mode=c["hysteresis_mode"])
    edges = 0
    for frame in pool(3, 150, 240, 12345678901):
        ours = oracle_edges(frame.numpy(), c["sigma"], c["min_val"],
                            c["max_val"], c["hysteresis_mode"])
        theirs = model(frame, c["min_val"], c["max_val"]).numpy()
        assert ours.dtype == np.int16
        edges += np.count_nonzero(ours)
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(
            ours, golden.canny(frame.numpy(), c["sigma"], c["min_val"],
                               c["max_val"]))
    assert edges > 0


@pytest.mark.parametrize("name", ["cam1080", "uhd4k"])
def test_control_fails(name):
    """The control reads above the limit 0 on three seeds at a size a test
    holds (the cell's own size: ``portbench/control.py`` on the card)."""
    c = config(name, 270, 480)
    control = program.make_control_model(c, torch.device("cpu"))
    for seed in (11, 12, 13):
        frame = pool(1, 270, 480, seed)[0]
        out = control(frame, c["min_val"], c["max_val"]).numpy()
        (n, first), = judge((frame.numpy(), c["sigma"], c["min_val"],
                             c["max_val"], c["hysteresis_mode"], [out]))
        assert n > 0 and first is not None


def test_judge_counts_every_differing_pixel():
    frame = pool(1, 40, 64, 5)[0].numpy()
    ref = oracle_edges(frame, 1.4, 30, 90, "component")
    bad = ref.copy()
    bad[3, 4] ^= 255
    bad[10, 11] ^= 255
    res = judge_all([(frame, 1.4, 30, 90, "component",
                      [ref, bad, ref.astype(np.int32)])], workers=2)
    assert res == [[(0, None), (2, (3, 4)), (ref.size, None)]]


def test_judge_all_keeps_task_order_and_leaves_no_process():
    """Tasks dealt to two workers come back in their order, and no worker
    (nor any other child) is left once the comparison has returned."""
    from portbench.harness.procs import children

    tasks = []
    for seed in (5, 6, 7):
        frame = pool(1, 40, 64, seed)[0].numpy()
        ref = oracle_edges(frame, 1.4, 30, 90, "component")
        bad = ref.copy()
        bad[seed, 2] ^= 255
        tasks.append((frame, 1.4, 30, 90, "component", [bad, ref]))
    assert judge_all(tasks, workers=2) == [[(1, (s, 2)), (0, None)]
                                           for s in (5, 6, 7)]
    assert children() == []
