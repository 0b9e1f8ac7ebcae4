"""PyTorch port: every frame JAX computes, the card computes too.

K1 takes any odd window: windows 3 to 103 take the tile path, wider ones the
ring path (a column strip streamed through a ring of x-pass rows) up to what
its shared memory holds (613 taps on the H100), wider ones still the scratch
path (the blur through device memory).  K4 takes any width: a band a
warp up to 8192 columns, a band a block up to 32768, beyond that several
words a thread, the band in shared memory where it fits and in device
memory where it does not.

On the CPU: the port at sigmas 43.66 to 100 (windows 263 to 601) on every
backend against ``golden`` (and once against ``CannyTPU``), the choice of
each path for a given shared-memory limit, and K4's plain version at 40000
columns against ``golden``.  On the card (marked ``cuda``): K1's ring and
scratch paths and K4's wide path against their plain versions.  Tolerance:
0 differing pixels everywhere.
"""

import ctypes

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
from canny_edge_tpu_torch.models.canny import canny_fn
from canny_edge_tpu_torch.ops import banded, window
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

H100_SMEM = 232448     # the H100's opt-in shared memory a block
SIGMAS = {43.66: 263, 43.67: 265, 50.0: 301, 100.0: 601}
MN, MX = 1, 2          # the blur of a sigma-100 window leaves small steps


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _frame(h=96, w=130):
    """A quarter disc of 255 in the top-left corner: edges that a blur of
    600 taps still leaves (a noise frame would have none)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.where(np.hypot(xx, yy) < 50, 255, 0).astype(np.uint8)


@pytest.mark.parametrize("sigma", sorted(SIGMAS))
@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
def test_large_sigma_equals_golden(sigma, backend):
    model = CannyTorch(sigma, backend=backend, device="cpu")
    assert model.window == SIGMAS[sigma]
    want = golden.canny(_frame(), sigma, MN, MX)
    got = model(_frame(), MN, MX).numpy()
    assert (want == 255).sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", sorted(SIGMAS))
def test_large_sigma_functional_equals_golden(sigma):
    """``canny_fn`` on the ``fused`` backend, a batch of two frames."""
    frames = np.stack([_frame(), _frame()[::-1].copy()])
    got = canny_fn(torch.from_numpy(frames), MN, MX, backend="fused",
                   kernel_vals=gaussian_kernel(sigma))
    for f, g in zip(frames, got.numpy()):
        np.testing.assert_array_equal(g, golden.canny(f, sigma, MN, MX))


@pytest.fixture(scope="module")
def jax_sigma_50():
    """``CannyTPU(50.0, backend="fused")`` on the frame: one JAX compile
    (~30 s) for the module."""
    from canny_edge_tpu.models import CannyTPU

    return np.asarray(CannyTPU(50.0, backend="fused")(_frame(), MN, MX))


def test_sigma_50_equals_cannytpu(jax_sigma_50):
    got = CannyTorch(50.0, device="cpu")(_frame(), MN, MX).numpy()
    assert (jax_sigma_50 == 255).sum() > 0
    np.testing.assert_array_equal(got, jax_sigma_50)
    np.testing.assert_array_equal(got, golden.canny(_frame(), 50.0, MN, MX))


@pytest.fixture(scope="module")
def k1_emu(tmp_path_factory):
    """K1's C source built for the CPU (``tools/cuda_emu``, ~6 s): its own
    answers for the shared memory and the largest window of a card whose
    opt-in limit the emulation sets."""
    from tools.cuda_emu import build

    return build("frontend", tmp_path_factory.mktemp("cuda_emu"))


def _max_window_at(lib, limit):
    """``canny_frontend_max_window`` on a card whose opt-in shared memory a
    block is ``limit`` bytes."""
    ctypes.c_int.in_dll(lib, "emu_optin").value = limit
    try:
        return lib.canny_frontend_max_window(1)
    finally:
        ctypes.c_int.in_dll(lib, "emu_optin").value = H100_SMEM


@pytest.mark.parametrize("limit,last", [(H100_SMEM, 613), (101376, 101),
                                        (49152, 7)])
def test_k1_path_for_smem_limit(k1_emu, limit, last):
    """Windows 3 to 103 take the tile path, wider ones the ring path, as
    far as every window up to them fits the limit, the scratch path every
    wider one; 613 on the H100 (227 KB a block), 101 at 99 KB (the tile of
    103 taps needs 102160 bytes)."""
    top = _max_window_at(k1_emu, limit)
    assert top == last
    fits = k1_emu.canny_frontend_smem_bytes
    assert fits(last, 1) <= limit < fits(last + 2, 1)
    for w in (3, 7):
        assert kfe.k1_path(w, top) == "tile"
    for w in (17, 81, 103, 105, 263, 265, 601, last):
        if w <= last:
            assert kfe.k1_path(w, top) == ("tile" if w <= 103 else "ring")
    for w in (last + 2, last + 36, 701, 1001):
        assert kfe.k1_path(w, top) == "scratch"


def test_k1_scratch_floats(k1_emu):
    """The scratch path's float32 scratch: divisors, the row blur over the
    window's reach and the floored blur, each output column + 4 wide; 701
    taps is past the ring path on the H100."""
    assert kfe.k1_path(701, _max_window_at(k1_emu, H100_SMEM)) == "scratch"
    assert kfe.scratch_floats(1, 1080, 1920, 701) == (
        1924 + 1084 + 0 + 1924 * (1084 + 700) + 1924 * 1084)
    assert kfe.scratch_floats(3, 1, 1, 3) == 12 + 3 * 5 * (5 + 2 + 5)


@pytest.mark.parametrize("window,want", [(105, 65600), (263, 117488),
                                         (601, 228288), (613, 232352)])
def test_k1_ring_smem_bytes(k1_emu, window, want):
    """The ring path's shared memory, as the C source computes it: taps,
    72 + 516 divisors, 36 x 72 blurred floats, 34 x 68 int16 magnitudes,
    32 + 2c + 8 ring rows of 73 floats (16-byte rounded), 32 staging rows
    of an odd number of words and 16 bytes to spare; it grows by the ring's
    two rows a window step.  Window 103 is the tile path's."""
    c = window // 2
    ring = ((32 + 2 * c + 8) * 73 * 4 + 15) // 16 * 16
    sw = (((75 + 2 * c + 3) // 4) | 1) * 4
    assert sw % 8 == 4 and sw >= 76 + 2 * c
    assert want == ((window + 3) // 4 * 16 + (72 + 512 + 4) * 4
                    + 36 * 72 * 4 + 34 * 68 * 2 + ring + 32 * sw + 16)
    assert k1_emu.canny_frontend_smem_bytes(window, 1) == want
    assert k1_emu.canny_frontend_smem_bytes(103, 1) == 102160


@pytest.mark.parametrize("w,band,asked,want", [
    (1920, 64, False, ("warp", 64)),
    (7680, 150, False, ("warp", 75)),        # halved: 152 rows do not fit
    (8192, 8, False, ("warp", 8)),
    (8193, 8, False, ("block", 8)),
    (32768, 64, False, ("block", 16)),
    (32769, 130, False, ("wide", 17)),
    (40000, 130, False, ("wide", 17)),
    (131072, 130, False, ("wide", 3)),
    (131072, 8, True, ("wide-global", 8)),   # asked, does not fit: memory
    (524288, 130, False, ("wide-global", 130)),
    (2 ** 21, 8, False, ("wide-global", 8)),
])
def test_k4_plan_for_width(w, band, asked, want):
    assert k4.k4_plan(w, band, asked, H100_SMEM) == want


def test_k4_plan_refusals_stay():
    """Up to 32768 columns a band that was asked for and does not fit is
    refused, as before; past them nothing is."""
    with pytest.raises(ValueError, match="pass a smaller band_h"):
        k4.k4_plan(7680, 150, True, H100_SMEM)
    with pytest.raises(ValueError, match="pass a smaller band_h"):
        k4.k4_plan(32768, 64, True, H100_SMEM)
    assert k4.k4_plan(32769, 64, True, H100_SMEM)[0] == "wide-global"


def test_k4_smem_bytes_paths():
    """Two masks of band_h + 2 rows a band; the warp and block paths add
    two flag words a 32 rows, the wide path a seed row; past 8192 columns
    the block scan's 384 static bytes."""
    assert k4.smem_bytes(64, 1920) == 4 * (2 * 66 * 60 + 2 * 3)
    assert k4.smem_bytes(8, 32768) == 4 * (2 * 10 * 1024 + 2) + 384
    assert k4.smem_bytes(8, 40000) == 4 * (2 * 10 * 1250 + 1250) + 384


def _thin_nm(h, w, seed):
    """A serpentine that crosses the whole width and random values."""
    rng = np.random.default_rng(seed)
    nm = np.where(rng.random((h, w)) < 0.3, rng.integers(0, 100, (h, w)),
                  0).astype(np.int32)
    for r in range(1, h - 1, 3):
        nm[r, 1:w - 1] = 30
    for i, r in enumerate(range(1, h - 3, 3)):
        nm[r:r + 4, w - 2 if i % 2 == 0 else 1] = 30
    nm[1, 1] = 200
    return nm


@pytest.mark.parametrize("h,w,band_h", [(10, 40000, None), (7, 40000, 3)])
def test_k4_plain_wide_equals_golden(h, w, band_h):
    nm = _thin_nm(h, w, seed=w + h)
    want = golden.hysteresis(nm, 20, 90)
    got, sweeps = k4.hysteresis_banded(torch.from_numpy(nm), 20, 90,
                                       band_h=band_h, return_sweeps=True)
    assert (want == 255).sum() > w
    np.testing.assert_array_equal(got.numpy(), want)
    assert sweeps >= 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_mode_choice_mirrors_the_library(cuda_device):
    """K1's largest window on the card is the largest whose block fits its
    shared memory, and the wrapper's choice follows it; K4's mirrors of the
    choice equal the library's own answers."""
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.utils.constants import smem_optin_bytes

    limit = smem_optin_bytes(cuda_device)
    top = kfe.max_window(cuda_device)
    fits = _build.load("frontend").canny_frontend_smem_bytes
    assert fits(top, 1) <= limit < fits(top + 2, 1)
    assert kfe.k1_path(top, top) != "scratch"
    assert kfe.k1_path(top + 2, top) == "scratch"
    lib = _build.load("hysteresis_banded")
    assert lib.canny_banded_smem_limit() == limit
    for band, w in ((64, 1920), (8, 32768), (8, 32769), (3, 131072),
                    (130, 524288)):
        assert lib.canny_banded_smem_bytes(band, w) == k4.smem_bytes(band, w)
        path, fit = k4.k4_plan(w, band, True, limit)
        assert (lib.canny_banded_row_words(1, 64, w, fit) > 0) == (
            path == "wide-global")


WIDE_SIGMAS = {17: 2.5, 19: 3.0, 31: 5.0, 61: 10.0, 103: 17.0, 105: 17.2,
               121: 20.0, 263: 43.66, 265: 43.67, 601: 100.0}


@pytest.mark.cuda
@pytest.mark.parametrize("win", sorted(WIDE_SIGMAS))
def test_card_k1_ring_path_equals_plain(cuda_device, win):
    """Windows from 17 taps on the path each takes (the tile path's
    unrolled instantiations up to 103, the ring path above) in frame, batch
    and block mode, NMS map and masks, at shapes off the 64-column strip
    and the 32-row step (257x333), a single row (1x1000) and a single
    column (40x1); each ring launch in the ring counters with its
    geometry."""
    from bench_torch import make_image

    kern = gaussian_kernel(WIDE_SIGMAS[win])
    assert len(kern) == win
    path = kfe.k1_path(win, kfe.max_window(cuda_device))
    assert path == ("tile" if win <= 103 else "ring")
    taps = torch.from_numpy(kern).to(cuda_device)

    def ring():
        return np.array([kfe.ring_launches, kfe.ring_blocks,
                         kfe.ring_segments, kfe.ring_xpass_rows,
                         kfe.ring_out_rows])

    def geometry(b, oh, ow):
        if path != "ring":
            return 0
        g = kfe.ring_geometry(b, oh, ow, win, cuda_device)
        return np.array([1, g.blocks, g.segments, g.xpass_rows, g.out_rows])

    before, counted = ring(), 0
    for h, w in ((257, 333), (1, 1000), (40, 1)):
        imgs = torch.from_numpy(np.stack([make_image(h, w, seed=s)
                                          for s in range(3)])).to(cuda_device)
        nm = kfe.frontend(imgs, taps)
        weak, strong = kfe.frontend(imgs[1], taps, (5, 20))
        counted = counted + geometry(3, h, w) + geometry(1, h, w)
        for i in range(3):
            assert torch.equal(nm[i].to(torch.int32),
                               window.frontend_nm(imgs[i], kern))
        ref_w, ref_s = window.frontend_nm(imgs[1], kern, (5, 20))
        assert torch.equal(weak.view(torch.int32), ref_w.view(torch.int32))
        assert torch.equal(strong.view(torch.int32), ref_s.view(torch.int32))
    img = torch.from_numpy(make_image(257, 333, seed=7)).to(cuda_device)
    r = win // 2 + 2
    pad = torch.nn.functional.pad(img, (r, r, r, r))
    for row0, col0, hl, wl in ((0, 0, 129, 167), (60, 90, 100, 150),
                               (128, 166, 129, 167)):
        blk_win = pad[row0:row0 + hl + 2 * r,
                      col0:col0 + wl + 2 * r].contiguous()
        blk = kfe.frontend_block(blk_win, row0, col0, 257, 333, taps)
        assert torch.equal(blk.to(torch.int32), window.frontend_block(
            blk_win, row0, col0, 257, 333, kern))
        got = kfe.frontend_block(blk_win, row0, col0, 257, 333, taps,
                                 (5, 20))
        counted = counted + 2 * geometry(1, hl, wl)
        want = window.frontend_block(blk_win, row0, col0, 257, 333, kern,
                                     (5, 20))
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))
    moved = ring() - before
    assert moved[0] == (12 if path == "ring" else 0)
    assert (moved == counted).all()


# (frames, rows, columns, the blocks, segments and longest block's steps on
# the H100's 132 co-resident blocks): the wide cell's batch and a pair of
# 4K frames, each in 132 spans across strips and frames, with segments
# longer than the 512 rows whose divisors a block holds at once
LONG_RUNS = [(8, 1080, 1920, (132, 360, 62)), (2, 2160, 3840, (132, 240, 62))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,want", LONG_RUNS)
def test_card_k1_ring_long_runs_equal_plain(cuda_device, b, h, w, want):
    """At 121 taps (sigma 20) a batch that overfills the card takes one
    span a co-resident block, across strips and frames: NMS map and masks
    equal to the plain version frame by frame, and the launch in the ring
    counters with its geometry."""
    from bench_torch import make_image

    kern = gaussian_kernel(20.0)
    assert len(kern) == 121
    g = kfe.ring_geometry(b, h, w, 121, cuda_device)
    assert (g.slots, g.blocks, g.segments, g.steps) == (132, *want)
    taps = torch.from_numpy(kern).to(cuda_device)
    imgs = torch.from_numpy(np.stack([make_image(h, w, seed=s)
                                      for s in range(b)])).to(cuda_device)
    before = np.array([kfe.ring_launches, kfe.ring_blocks,
                       kfe.ring_segments, kfe.ring_xpass_rows,
                       kfe.ring_out_rows])
    nm = kfe.frontend(imgs, taps)
    weak, strong = kfe.frontend(imgs, taps, (4, 12))
    moved = np.array([kfe.ring_launches, kfe.ring_blocks,
                      kfe.ring_segments, kfe.ring_xpass_rows,
                      kfe.ring_out_rows]) - before
    assert (moved == 2 * np.array([1, g.blocks, g.segments, g.xpass_rows,
                                   g.out_rows])).all()
    for i in range(b):
        assert torch.equal(nm[i].to(torch.int32),
                           window.frontend_nm(imgs[i], kern))
        ref_w, ref_s = window.frontend_nm(imgs[i], kern, (4, 12))
        assert torch.equal(weak[i].view(torch.int32), ref_w.view(torch.int32))
        assert torch.equal(strong[i].view(torch.int32),
                           ref_s.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [116.5, 150.0])
def test_card_k1_scratch_path_equals_plain(cuda_device, sigma):
    """Windows past the ring path's (701 and 901 taps) take the scratch
    path, in batch, threshold and block mode."""
    from bench_torch import make_image

    kern = gaussian_kernel(sigma)
    assert kfe.k1_path(len(kern), kfe.max_window(cuda_device)) == "scratch"
    taps = torch.from_numpy(kern).to(cuda_device)
    before = kfe.scratch_launches
    imgs = torch.from_numpy(np.stack([make_image(257, 333, seed=s)
                                      for s in range(3)])).to(cuda_device)
    nm = kfe.frontend(imgs, taps)
    weak, strong = kfe.frontend(imgs[0], taps, (5, 20))
    for i in range(3):
        assert torch.equal(nm[i].to(torch.int32),
                           window.frontend_nm(imgs[i], kern))
    ref_w, ref_s = window.frontend_nm(imgs[0], kern, (5, 20))
    assert torch.equal(weak.view(torch.int32), ref_w.view(torch.int32))
    assert torch.equal(strong.view(torch.int32), ref_s.view(torch.int32))
    r = len(kern) // 2 + 2
    pad = torch.nn.functional.pad(imgs[1], (r, r, r, r))
    win = pad[60:160 + 2 * r, 90:240 + 2 * r].contiguous()
    blk = kfe.frontend_block(win, 60, 90, 257, 333, taps)
    assert torch.equal(blk.to(torch.int32),
                       window.frontend_block(win, 60, 90, 257, 333, kern))
    assert kfe.scratch_launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(96, 32769), (70, 40000), (64, 131072),
                                 (16, 524288)])
def test_card_k4_wide_equals_plain(cuda_device, h, w):
    nm = torch.from_numpy(_thin_nm(h, w, seed=w)).to(cuda_device)
    before = k4.wide_launches
    out, st = k4.banded_stats(nm, 20, 90)
    ref, sweeps = banded.hysteresis_banded(nm, 20, 90, band_h=st["band_h"],
                                           return_sweeps=True)
    assert torch.equal(out, ref) and st["sweeps"] == sweeps
    assert int((ref > 0).sum()) > w
    assert k4.wide_launches == before + 1
