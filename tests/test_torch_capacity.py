"""PyTorch port: every frame JAX computes, the card computes too.

K1 takes any odd window: windows whose tile fits a block's shared memory
(263 taps on the H100, sigma <= 43.66) take the tile path, wider ones the
scratch path (the blur through device memory).  K4 takes any width: a band a
warp up to 8192 columns, a band a block up to 32768, beyond that several
words a thread, the band in shared memory where it fits and in device
memory where it does not.

On the CPU: the port at sigmas on both sides of the tile path's last window
and at 50 and 100 on every backend against ``golden`` (and once against
``CannyTPU``), the choice of each path for a given shared-memory limit, and
K4's plain version at 40000 columns against ``golden``.  On the card
(marked ``cuda``): both new modes against their plain versions.  Tolerance:
0 differing pixels everywhere.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("limit,last", [(H100_SMEM, 263), (101376, 101),
                                        (49152, 7)])
def test_k1_path_for_smem_limit(limit, last):
    """The tile path takes the windows whose tile fits the limit, the
    scratch path every wider one; 263 on the H100 (227 KB a block)."""
    assert kfe.max_tile_window(limit) == last
    assert kfe.tile_smem_bytes(last) <= limit < kfe.tile_smem_bytes(last + 2)
    for w in (3, 7, last):
        assert kfe.k1_path(w, kfe.max_tile_window(limit)) == "tile"
    for w in (last + 2, last + 36, 601, 1001):
        assert kfe.k1_path(w, kfe.max_tile_window(limit)) == "scratch"


def test_k1_scratch_floats():
    """The scratch path's float32 scratch: divisors, the row blur over the
    window's reach and the floored blur, each output column + 4 wide."""
    assert kfe.scratch_floats(1, 1080, 1920, 601) == (
        1924 + 1084 + 0 + 1924 * (1084 + 600) + 1924 * 1084)
    assert kfe.scratch_floats(3, 1, 1, 3) == 12 + 3 * 5 * (5 + 2 + 5)


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
    """The mirrors of the choice equal the library's own answers."""
    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.utils.constants import smem_optin_bytes

    limit = smem_optin_bytes(cuda_device)
    assert kfe.max_window(cuda_device) == kfe.max_tile_window(limit)
    lib = _build.load("hysteresis_banded")
    assert lib.canny_banded_smem_limit() == limit
    for band, w in ((64, 1920), (8, 32768), (8, 32769), (3, 131072),
                    (130, 524288)):
        assert lib.canny_banded_smem_bytes(band, w) == k4.smem_bytes(band, w)
        path, fit = k4.k4_plan(w, band, True, limit)
        assert (lib.canny_banded_row_words(1, 64, w, fit) > 0) == (
            path == "wide-global")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [43.67, 100.0])
def test_card_k1_scratch_path_equals_plain(cuda_device, sigma):
    from bench_torch import make_image

    kern = gaussian_kernel(sigma)
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
