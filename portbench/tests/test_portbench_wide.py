"""The coarse-scale configuration (``configs/cam1080wide.json``: sigma 20,
a 121-tap window, thresholds 4/12) on the CPU at small sizes: its frames
through the port's plain CPU path give the frozen oracle's edges, dense
ones, and the control (taps rounded to bfloat16) does not.  Its cell,
``cam1080wide.batch8``, runs in ``test_portbench_run.py`` with the others,
at this file's size."""

import json

import numpy as np
import torch

from canny_edge_tpu_torch import CannyTorch
from portbench.harness import program
from portbench.harness.spec import ROOT
from portbench.reference import frames
from portbench.reference.compare import judge, oracle_edges
from portbench.reference.oracle import gaussian_window

from test_portbench_run import SIZES

H, W = SIZES["cam1080wide"]


def config():
    with open(ROOT / "portbench" / "configs" / "cam1080wide.json") as f:
        return dict(json.load(f), height=H, width=W)


def pool(n, seed):
    """Frames of the cell's scene at its own scale, a sixth of its size."""
    params = frames.frame_params(n, H, W, seed)
    return frames.make_pool(params, H, W, seed, torch.device("cpu"), W)


def test_the_window_is_121_taps():
    c = config()
    assert gaussian_window(c["sigma"]) == 121
    assert (c["min_val"], c["max_val"]) == (4, 12)
    assert (c["backend"], c["hysteresis_mode"]) == ("fused", "component")


def test_oracle_is_the_ports_plain_path():
    c = config()
    model = CannyTorch(sigma=c["sigma"], device="cpu", backend=c["backend"],
                       hysteresis_mode=c["hysteresis_mode"])
    batch = pool(3, 2**33 + 18)
    ours = model.batch(batch, c["min_val"], c["max_val"]).numpy()
    edges = 0
    for frame, theirs in zip(batch, ours):
        ref = oracle_edges(frame.numpy(), c["sigma"], c["min_val"],
                           c["max_val"], c["hysteresis_mode"])
        np.testing.assert_array_equal(ref, theirs)
        edges += np.count_nonzero(ref)
    assert edges > 0.002 * batch.numel()


def test_control_fails():
    """The control reads above the limit 0 on three seeds at this size
    (the cell's own size: ``portbench/control.py`` on the card)."""
    c = config()
    control = program.make_control_model(c, torch.device("cpu"))
    for seed in (21, 22, 23):
        frame = pool(1, seed)[0]
        out = control(frame, c["min_val"], c["max_val"]).numpy()
        (n, first), = judge((frame.numpy(), c["sigma"], c["min_val"],
                             c["max_val"], c["hysteresis_mode"], [out]))
        assert n > 0 and first is not None
