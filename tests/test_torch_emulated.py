"""PyTorch port: K1's CUDA source run on the CPU, under ``tools/cuda_emu``.

The card's compiler is not here.  This builds
``canny_edge_tpu_torch/kernels/csrc/frontend.cu`` with g++ against
``tools/cuda_emu`` (every CUDA thread a fiber, the barriers and ballots
among them, the host's IEEE float32 with no contraction) and holds K1's
tile, ring and scratch paths, in frame, batch and block mode, NMS map and
packed masks, equal to the plain front end (``ops/window.py``) at small
shapes; the emulated card's SM count makes a strip several runs (several
blocks down a column) or one block's span several strips and frames, so
runs, spans, steps, the ring's wrap and its mirror rows are all crossed.
Its answer for the largest window of the tile and ring paths is the
largest whose shared memory fits, at two limits, and the ring path's
launch geometry (``canny_frontend_ring_geometry``) is the grid it
launches, whose blocks' spans (``canny_frontend_ring_spans``) cover the
launch's steps once each: equal runs chosen by the card's waves, or spans
across strips and frames, one a co-resident block, where the launch rule
prices them lower (the wide cell's batch: 132 spans of at most 62 steps;
runs past the 512 rows whose divisors a block holds at once).  The launch plan's entry (``canny_run_plan``) runs K1 into the
plan's masks, then K2's entry, here a stand-in that records its arguments
or runs the plain flood.  What only the card shows (that nvcc builds the
source, its speed) is in the ``cuda``-marked tests.  Tolerance: 0
differing values.
"""

import contextlib
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from bench_torch import make_image
from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.kernels import plan as kplan
from canny_edge_tpu_torch.kernels._build import SIGNATURES
from canny_edge_tpu_torch.ops import window
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
from canny_edge_tpu_torch.ops.packed import cdiv
from tools.cuda_emu import build

MN, MX = 5, 20
ROOT = Path(__file__).resolve().parents[1]
# the bytes a pixel that K1's C entries take for a uint8 frame
U8 = 1


@pytest.fixture(scope="module")
def k1(tmp_path_factory):
    """K1 built for the CPU, once for the module (~6 s)."""
    return build("frontend", tmp_path_factory.mktemp("cuda_emu"))


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    """K1 built once for each emulated card of ``sms`` SMs asked for, that
    card made current: the library keeps a window's co-resident blocks from
    its first ask, so a test whose ring geometry rests on the card's size
    takes a library of its own card (~6 s a build)."""
    libs = {}

    def card(sms):
        if sms not in libs:
            libs[sms] = build("frontend",
                              tmp_path_factory.mktemp(f"cuda_emu_{sms}"))
        _card(libs[sms], sms)
        return libs[sms]

    return card


def _card(lib, sms, optin=232448):
    ctypes.c_int.in_dll(lib, "emu_sms").value = sms
    ctypes.c_int.in_dll(lib, "emu_optin").value = optin


def _frame(h, w, seed=0):
    """The headline frame with a disc of 255 from its top-left corner:
    edges that a wide blur keeps."""
    img = make_image(h, w, seed=seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.hypot(xx, yy) < min(h, w) / 2] = 255
    return torch.from_numpy(img)


def _outputs(lead, h, w, thresholds):
    if thresholds is None:
        nm = torch.zeros((*lead, h, w), dtype=torch.int16)
        return (nm,), (0, 0, 0, nm.data_ptr(), None, None)
    weak = torch.zeros((*lead, h, cdiv(w, 32)), dtype=torch.uint32)
    strong = torch.zeros_like(weak)
    return (weak, strong), (1, *thresholds, None, weak.data_ptr(),
                            strong.data_ptr())


def _ring_geometry(lib, b, oh, ow, window):
    """The C entry's geometry, or its error."""
    geo = (ctypes.c_longlong * 7)()
    err = lib.canny_frontend_ring_geometry(b, oh, ow, window, geo, U8)
    return kfe.RingGeometry(*geo) if err == 0 else err


def _spans(lib, b, oh, ow, window):
    """The C entry's geometry, and its blocks' spans of the launch's steps
    (a ``(blocks, 2)`` array of first step and the step past the last)."""
    g = _ring_geometry(lib, b, oh, ow, window)
    span = (ctypes.c_longlong * (2 * g.blocks))()
    assert lib.canny_frontend_ring_spans(b, oh, ow, window, span,
                                         g.blocks) == 0
    return g, np.array(span, dtype=np.int64).reshape(-1, 2)


def _segments(spans, steps):
    """The segments of each span: the columns of ``steps`` steps it
    meets."""
    return (spans[:, 1] - 1) // steps - spans[:, 0] // steps + 1


def _covers(g, spans, b, oh, ow, window):
    """The spans cover each (frame, strip, step) of the launch once, and
    the geometry's segments, longest block and rows are theirs."""
    steps = cdiv(oh, 32)
    total = g.strips * b * steps
    assert g.strips == cdiv(ow, 64) and g.blocks == len(spans)
    first, past = np.sort(spans[:, 0]), np.sort(spans[:, 1])
    assert (past > first).all() and first[0] == 0 and past[-1] == total
    assert (first[1:] == past[:-1]).all()
    assert g.segments == _segments(spans, steps).sum()
    assert g.steps == (spans[:, 1] - spans[:, 0]).max()
    assert g.xpass_rows == g.segments * (4 + window // 2 * 2) + 32 * total
    assert g.out_rows == g.strips * b * oh


def _launched_is_the_geometry(lib, b, oh, ow, window):
    """The grid of the last launch holds the ring geometry's blocks, as
    (strips, runs, frames) for equal runs, each one segment, or as (blocks)
    for spans across strips and frames; the spans cover the launch."""
    g, spans = _spans(lib, b, oh, ow, window)
    grid = tuple((ctypes.c_uint * 3).in_dll(lib, "emu_grid"))
    if grid != (g.blocks, 1, 1):
        assert grid[0] == g.strips and grid[2] == b
        assert grid[0] * grid[1] * grid[2] == g.blocks == g.segments
    _covers(g, spans, b, oh, ow, window)


def _same(got, want):
    return torch.equal(got.view(torch.int32) if got.dtype == torch.uint32
                       else got.to(torch.int32),
                       want.view(torch.int32) if want.dtype == torch.uint32
                       else want)


@pytest.mark.parametrize("limit", [232448, 101376])
def test_emulated_max_window_is_the_mirror(k1, limit):
    """The largest window mirrors the shared memory a window takes: every
    odd window up to it fits the limit, the next does not."""
    _card(k1, 4, optin=limit)
    top = k1.canny_frontend_max_window(U8)
    _card(k1, 4)

    def fits(w):
        return k1.canny_frontend_smem_bytes(w, U8)

    assert top >= 101
    assert all(fits(w) <= limit for w in range(3, top + 1, 2))
    assert fits(top + 2) > limit


# (window, frame, emulated SMs): the tile path at 11, 17 and 103, the ring
# path from 105 (one run, and runs of 32 to 96 rows), sigma 43.66 and 100
# (263, 601 taps)
FRAMES = [(11, (70, 100), 4), (17, (40, 70), 64), (103, (70, 100), 4),
          (105, (130, 70), 64), (121, (96, 130), 1), (263, (150, 96), 2),
          (601, (120, 64), 1)]


@pytest.mark.parametrize("win,hw,sms", FRAMES)
def test_emulated_frame_equals_plain(k1, win, hw, sms):
    kern = gaussian_kernel((win // 2 - 0.5) / 3)
    assert len(kern) == win
    _card(k1, sms)
    img = _frame(*hw, seed=win)
    taps = torch.from_numpy(kern)
    ref = window.frontend_nm(img, kern)
    assert (ref > 0).any()
    for thr in (None, (MN, MX)):
        got, out = _outputs((), *hw, thr)
        assert k1.canny_frontend(img.data_ptr(), U8, 1, *hw, taps.data_ptr(),
                                 win, *out, None) == 0
        want = (ref,) if thr is None else window.frontend_nm(img, kern, thr)
        assert all(_same(g, w) for g, w in zip(got, want))
        if win > 103:
            _launched_is_the_geometry(k1, 1, *hw, win)


@pytest.mark.parametrize("hw", [(37, 45), (1, 50), (45, 1)])
def test_emulated_batch_equals_plain(k1, hw):
    """A batch of 3 frames in one launch of the ring path (blockIdx.z the
    frame), at shapes whose frames start off 4-byte boundaries, a single
    row, a single column."""
    kern = gaussian_kernel(17.5)
    assert len(kern) == 107
    _card(k1, 16)
    imgs = torch.stack([_frame(*hw, seed=s) for s in range(3)])
    taps = torch.from_numpy(kern)
    (nm,), out = _outputs((3,), *hw, None)
    assert k1.canny_frontend(imgs.data_ptr(), U8, 3, *hw, taps.data_ptr(),
                             len(kern), *out, None) == 0
    _launched_is_the_geometry(k1, 3, *hw, len(kern))
    for i in range(3):
        assert _same(nm[i], window.frontend_nm(imgs[i], kern))


@pytest.mark.parametrize("row0,col0,hl,wl", [(0, 0, 45, 75), (45, 75, 45, 75),
                                            (20, 30, 40, 64),
                                            (70, 120, 40, 64)])
def test_emulated_block_equals_plain(k1, row0, col0, hl, wl):
    """Block mode on the ring path: a window with a halo of window // 2 + 2
    at its global offsets, blocks at the corner, inside and past the
    image."""
    H, W = 90, 150
    kern = gaussian_kernel(17.5)
    r = len(kern) // 2 + 2
    _card(k1, 4)
    pad = torch.nn.functional.pad(_frame(H, W, seed=3), (r, r + 64, r, r + 64))
    win = pad[row0:row0 + hl + 2 * r, col0:col0 + wl + 2 * r].contiguous()
    taps = torch.from_numpy(kern)
    for thr in (None, (MN, MX)):
        got, out = _outputs((), hl, wl, thr)
        assert k1.canny_frontend_block(win.data_ptr(), hl, wl, r, row0, col0,
                                       H, W, taps.data_ptr(), len(kern), *out,
                                       None) == 0
        want = window.frontend_block(win, row0, col0, H, W, kern, thr)
        assert all(_same(g, w) for g, w in zip(got, (want,) if thr is None
                                               else want))


def test_emulated_ring_geometry_of_the_wide_cell(cards, monkeypatch):
    """A batch of 8 1080p frames at 121 taps on the H100's 132 co-resident
    blocks: 30 strips of 34 steps, 240 columns, 8160 steps in 132 spans of
    61-62 steps, one wave, each of 2-3 segments (360 in all: 120 spans start
    inside a strip), a segment x-passing its steps' rows and 124 rows of
    prologue (a recompute of 1.18); no geometry off the ring path, for an
    empty batch or past the ring's shared memory.  The wrapper
    (``kernels/frontend.py:ring_geometry``) reads the same entry."""
    k1 = cards(132)
    got, spans = _spans(k1, 8, 1080, 1920, 121)
    want = kfe.RingGeometry(132, 30, 360, 62, 132, 360 * 124 + 32 * 8160,
                            240 * 1080)
    assert got == want
    _covers(got, spans, 8, 1080, 1920, 121)
    assert set(spans[:, 1] - spans[:, 0]) == {61, 62}
    assert set(_segments(spans, 34)) == {2, 3}
    for bad in ((8, 1080, 1920, 103), (8, 1080, 1920, 120),
                (0, 1080, 1920, 121), (8, 0, 1920, 121),
                (8, 1080, 1920, k1.canny_frontend_max_window(U8) + 2)):
        assert _ring_geometry(k1, *bad) != 0, bad
    monkeypatch.setattr(kfe._build, "load", lambda name: k1)
    monkeypatch.setattr(kfe._build, "device_guard",
                        lambda dev: contextlib.nullcontext())
    assert kfe.ring_geometry(8, 1080, 1920, 121, None) == want
    with pytest.raises(RuntimeError, match="ring_geometry: CUDA error 1"):
        kfe.ring_geometry(8, 1080, 1920, 103, None)


# a prologue row's cost against a step row's, in tenths, as the launch
# rule prices it (csrc/frontend.cu:RING_W10)
RING_W10 = int(re.search(r"constexpr long long RING_W10 = (\d+);",
                         (ROOT / "canny_edge_tpu_torch" / "kernels" / "csrc"
                          / "frontend.cu").read_text())[1])


def _modelled(slots, b, oh, ow, window, runs, rows):
    """The launch rule's cost of a grid of ``runs`` runs of ``rows`` rows:
    waves of the card's co-resident blocks times a block's prologue and
    steps, in tenths of a step row."""
    blocks = cdiv(ow, 64) * b * runs
    return cdiv(blocks, slots) * (RING_W10 * (4 + window // 2 * 2)
                                  + 10 * rows)


def _runs_rule(slots, b, oh, ow, window):
    """The runs and rows that the equal-runs rule chooses: the run count of
    least modelled time (``_modelled``), on equal costs the fewer runs."""
    steps, best = cdiv(oh, 32), None
    for n in range(1, min(steps, 65535) + 1):
        r = cdiv(steps, n)
        cost = _modelled(slots, b, oh, ow, window, cdiv(steps, r), 32 * r)
        if best is None or cost < best[0]:
            best = (cost, cdiv(steps, r), 32 * r)
    return best[1:]


def _spans_modelled(slots, window, spans, steps):
    """The launch rule's cost of blocks walking ``spans``: waves of the
    card's co-resident blocks times the costliest block's prologues (one a
    segment) and steps, in tenths of a step row."""
    cost = (RING_W10 * (4 + window // 2 * 2) * _segments(spans, steps)
            + 10 * 32 * (spans[:, 1] - spans[:, 0]))
    return cdiv(len(spans), slots) * int(cost.max())


def _old_rule(slots, b, oh, ow):
    """The runs and rows that the rule before the wave model chose: as many
    runs as filled the co-resident blocks once, at most 512 rows a run."""
    runs = max(max(1, slots // (cdiv(ow, 64) * b)), cdiv(oh, 512))
    rows = cdiv(cdiv(oh, runs), 32) * 32
    return cdiv(oh, rows), rows


# (frames, rows, columns, window, the blocks, segments and longest block's
# steps wanted, or None): a single 1080p frame keeps 4 runs of 288 rows
# (120 blocks of 9 steps), a 4K frame takes 132 spans of 30-31 steps
# across its 60 strips (2 runs of 1088 rows before, 5 of 448 before
# that); then a grid of batches, shapes and ring windows
RULE = [(1, 1080, 1920, 121, (120, 120, 9)),
        (1, 2160, 3840, 121, (132, 180, 31))] + [
    (b, oh, ow, win, None) for win in (105, 121, 263, 613) for b in (1, 8)
    for oh, ow in ((1, 1), (37, 1000), (1080, 1920), (2160, 3840),
                   (100000, 64))]


@pytest.mark.parametrize("b,oh,ow,win,want", RULE)
def test_emulated_ring_runs_by_the_cards_waves(cards, b, oh, ow, win, want):
    """On the H100's 132 co-resident blocks, the ring path's blocks are the
    rule's: spans that cover each (frame, strip, step) once, within CUDA's
    grid limits (equal runs, or one span a co-resident block), and a
    modelled time never above the equal-runs rule's or the old rule's; the
    x-pass rows are each segment's prologue and steps."""
    k1 = cards(132)
    g, spans = _spans(k1, b, oh, ow, win)
    assert g.slots == 132
    if want is not None:
        assert (g.blocks, g.segments, g.steps) == want
    _covers(g, spans, b, oh, ow, win)
    steps = cdiv(oh, 32)
    if g.segments == g.blocks:           # equal runs: the grid's y <= 65535
        assert (_segments(spans, steps) == 1).all()
        assert cdiv(steps, g.steps) <= 65535
    else:                                # spans: one a slot, at most
        assert g.blocks <= 132
    assert g.strips < 2 ** 31 and b <= 65535
    got = _spans_modelled(132, win, spans, steps)
    assert got <= _modelled(132, b, oh, ow, win,
                            *_runs_rule(132, b, oh, ow, win))
    assert got <= _modelled(132, b, oh, ow, win,
                            *_old_rule(132, b, oh, ow))


def test_emulated_long_run_equals_plain(cards):
    """One segment longer than the 512 rows whose divisors a block holds at
    once (a 1100 x 64 frame at 105 taps on one co-resident block: one
    block, one segment of 35 steps, 1120 rows), so the y-pass warps refill
    the row divisors twice and the last refill reaches the image's bottom
    border: equal to the plain front end."""
    k1 = cards(1)
    kern = gaussian_kernel((105 // 2 - 0.5) / 3)
    assert len(kern) == 105
    hw = (1100, 64)
    img = _frame(*hw, seed=11)
    taps = torch.from_numpy(kern)
    ref = window.frontend_nm(img, kern)
    assert (ref > 0).any()
    for thr in (None, (MN, MX)):
        got, out = _outputs((), *hw, thr)
        assert k1.canny_frontend(img.data_ptr(), U8, 1, *hw, taps.data_ptr(),
                                 105, *out, None) == 0
        want = (ref,) if thr is None else window.frontend_nm(img, kern, thr)
        assert all(_same(g, w) for g, w in zip(got, want))
    _launched_is_the_geometry(k1, 1, *hw, 105)
    assert _ring_geometry(k1, 1, *hw, 105)[1:5] == (1, 1, 35, 1)


# (window, frames, frame, emulated SMs, the blocks and segments wanted): on
# one co-resident block one span walks every strip of every frame; on 3, a
# batch of 2 frames of 2 strips takes 3 spans, two of which start inside a
# strip
SPANS = [(win, b, hw, sms, want) for win in (105, 121)
         for b, hw, sms, want in ((3, (45, 100), 1, (1, 6)),
                                  (2, (300, 70), 3, (3, 6)))]


@pytest.mark.parametrize("win,b,hw,sms,want", SPANS)
def test_emulated_spans_across_strips_and_frames_equal_plain(
        cards, win, b, hw, sms, want):
    """Blocks whose spans cross strips and frames, with segments that
    start inside a strip: NMS map and masks of every frame equal to the
    plain front end, the grid one block a span."""
    k1 = cards(sms)
    kern = gaussian_kernel((win // 2 - 0.5) / 3)
    assert len(kern) == win
    imgs = torch.stack([_frame(*hw, seed=win + s) for s in range(b)])
    taps = torch.from_numpy(kern)
    g, spans = _spans(k1, b, *hw, win)
    assert (g.blocks, g.segments) == want
    starts = spans[:, 0] % cdiv(hw[0], 32)
    assert (starts > 0).sum() == (2 if sms > 1 else 0)
    for thr in (None, (MN, MX)):
        got, out = _outputs((b,), *hw, thr)
        assert k1.canny_frontend(imgs.data_ptr(), U8, b, *hw, taps.data_ptr(),
                                 win, *out, None) == 0
        assert tuple((ctypes.c_uint * 3).in_dll(k1, "emu_grid")) == \
            (g.blocks, 1, 1)
        for i in range(b):
            want_i = (window.frontend_nm(imgs[i], kern),) if thr is None \
                else window.frontend_nm(imgs[i], kern, thr)
            assert all(_same(a[i], w) for a, w in zip(got, want_i)), i


def test_emulated_scratch_path_past_the_ring(k1):
    """Past the ring's 613 taps the ring entry refuses and the scratch path
    computes the frame."""
    kern = gaussian_kernel(103.0)
    assert len(kern) == 619
    _card(k1, 4)
    h, w = 40, 64
    img = _frame(h, w)
    taps = torch.from_numpy(kern)
    (nm,), out = _outputs((), h, w, None)
    assert k1.canny_frontend(img.data_ptr(), U8, 1, h, w, taps.data_ptr(), 619,
                             *out, None) != 0
    n = kfe.scratch_floats(1, h, w, 619)
    scratch = torch.zeros(n, dtype=torch.float32)
    assert k1.canny_frontend_large(img.data_ptr(), U8, 1, 0, h, w, 0, 0, h, w,
                                   taps.data_ptr(), 619, *out,
                                   scratch.data_ptr(), n, None) == 0
    assert _same(nm, window.frontend_nm(img, kern))


# canny_hysteresis_packed's C signature (kernels/_build.py), for a stand-in
# K2 that the plan entry calls
FLOOD = ctypes.CFUNCTYPE(ctypes.c_int, *SIGNATURES["hysteresis_packed"][
    "canny_hysteresis_packed"])


# (window, output, what the stand-in K2 returns, the plan's device, what
# canny_run_plan returns): the tile path and the ring path, int16 and
# packed output, a K2 error (negated), a device that cannot be made
# current and a window K1 refuses (K1's error, K2 not called)
PLANS = [(11, "int16", 0, 0, 0), (121, "packed", 0, 0, 0),
         (11, "packed", 7, 0, -7), (19, "int16", 0, 1, 101),
         (1, "int16", 0, 0, 1)]


@pytest.mark.parametrize("win,kind,k2_err,device,want", PLANS)
def test_emulated_plan_runs_k1_then_k2(k1, win, kind, k2_err, device, want):
    """``canny_run_plan`` from an argument block laid out by
    ``kernels/plan.py:Args``: K1 fills the plan's masks with its bounds
    (equal to the plain front end's), then K2's entry is called once, with
    the plan's fields, the output and the token."""
    kern = gaussian_kernel((win // 2 - 0.5) / 3) if win > 1 else \
        np.ones(1, np.float32)
    _card(k1, 4)
    b, h, w = 2, 37, 70
    imgs = torch.stack([_frame(h, w, seed=s) for s in range(b)])
    taps = torch.from_numpy(kern)
    weak = torch.zeros((b, h, cdiv(w, 32)), dtype=torch.uint32)
    strong, edges = torch.zeros_like(weak), torch.zeros_like(weak)
    out = (torch.zeros_like(weak) if kind == "packed" else
           torch.zeros((b, h, w), dtype=torch.int16))
    ctl = torch.zeros(5, dtype=torch.int64)
    total = torch.zeros(1, dtype=torch.int64)
    calls = []

    def flood(*args):
        calls.append(args)
        return k2_err

    k2 = FLOOD(flood)
    args = kplan.Args(taps.data_ptr(), weak.data_ptr(), strong.data_ptr(),
                      None if kind == "packed" else edges.data_ptr(),
                      ctl.data_ptr(), total.data_ptr(), 1234,
                      ctypes.cast(k2, ctypes.c_void_p).value, device, b, h, w,
                      win, MN, MX, 1, U8)
    run = kplan._RUN(("canny_run_plan", k1))     # as a plan calls it
    assert run(ctypes.addressof(args), imgs.data_ptr(), out.data_ptr(),
               5 << 32) == want
    if want > 0:
        assert calls == []
        return
    for i in range(b):
        mw, ms = window.frontend_nm(imgs[i], kern, (MN, MX))
        assert _same(weak[i], mw) and _same(strong[i], ms)
    packed = kind == "packed"
    assert calls == [(weak.data_ptr(), strong.data_ptr(), None, 0, 0, 0,
                      (out if packed else edges).data_ptr(),
                      None if packed else out.data_ptr(), b, h, w, 1, 0, 0,
                      ctl.data_ptr(), total.data_ptr(), 5 << 32, 1234)]


def test_emulated_plan_at_the_wide_cells_sigma(k1):
    """The wide cell's configuration (``portbench/configs/cam1080wide.json``:
    sigma 20, a window of 121 on K1's ring path, thresholds 4/12) on a
    batch of 3 small frames through ``canny_run_plan``, K2 a stand-in that
    runs the plain flood on the plan's masks: bit for bit the plain
    pipeline's edges."""
    conf = json.loads((ROOT / "portbench" / "configs" /
                       "cam1080wide.json").read_text())
    kern = gaussian_kernel(conf["sigma"])
    mn, mx = conf["min_val"], conf["max_val"]
    assert len(kern) == 121 and (mn, mx) == (4, 12)
    _card(k1, 4)
    assert kfe.k1_path(121, k1.canny_frontend_max_window(U8)) == "ring"
    b, h, w = 3, 96, 160
    imgs = torch.stack([_frame(h, w, seed=s) for s in range(b)])
    taps = torch.from_numpy(kern)
    weak = torch.zeros((b, h, cdiv(w, 32)), dtype=torch.uint32)
    strong, edges = torch.zeros_like(weak), torch.zeros_like(weak)
    out = torch.zeros((b, h, w), dtype=torch.int16)
    ctl = torch.zeros(5, dtype=torch.int64)
    total = torch.zeros(1, dtype=torch.int64)

    def flood(*args):
        out.copy_(khp.hysteresis_packed(weak, strong, h, w,
                                        edges_int16=True))
        return 0

    k2 = FLOOD(flood)
    args = kplan.Args(taps.data_ptr(), weak.data_ptr(), strong.data_ptr(),
                      edges.data_ptr(), ctl.data_ptr(), total.data_ptr(), 0,
                      ctypes.cast(k2, ctypes.c_void_p).value, 0, b, h, w,
                      121, mn, mx, 0, U8)
    run = kplan._RUN(("canny_run_plan", k1))
    assert run(ctypes.addressof(args), imgs.data_ptr(), out.data_ptr(),
               1 << 32) == 0
    want = CannyTorch(conf["sigma"], device="cpu").batch(imgs, mn, mx)
    assert torch.equal(out, want) and (out == 255).any()
