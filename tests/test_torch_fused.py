"""PyTorch port, the ``pallas`` backend: the plain tiled-dilation (K3) and
banded (K4) hysteresis engines against the JAX engines (Pallas in
interpret mode) and the NumPy oracle, ``canny_fused`` with each
hysteresis_impl against JAX ``canny_fused``, the names it and the model
refuse, and on the card the kernels against their plain versions.
Tolerance: 0 differing pixels everywhere.

Inputs are made from NumPy seeds and cross between the frameworks as NumPy
arrays; JAX runs on the CPU.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu.golden.reference import gaussian_kernel
from canny_edge_tpu.io.imageio import synthetic_image
from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.kernels import hysteresis as k3
from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
from canny_edge_tpu_torch.kernels.fused import canny_fused
from canny_edge_tpu_torch.kernels.hysteresis_packed import hysteresis_packed_nm
from canny_edge_tpu_torch.ops import banded, dilate
from canny_edge_tpu_torch.ops.packed import hysteresis_packed

IMPLS = ["packed", "packed-xla", "banded", "dilate"]


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def kv(sigma):
    return tuple(float(v) for v in gaussian_kernel(sigma))


def _nm(h, w, seed=0):
    """The golden NMS map of a synthetic frame (int16)."""
    img = synthetic_image(h, w, seed=seed)
    return golden.nonmax_suppression(*golden.sobel(golden.gaussian_blur(img, 1.0)))


def _snake(h, w):
    """Serpentine weak chain with one strong seed: many sweeps."""
    nm = np.zeros((h, w), np.int16)
    for r in range(4, h - 4, 8):
        nm[r, 4:w - 4] = 30
    for i, r in enumerate(range(4, h - 12, 8)):
        c = w - 5 if i % 2 == 0 else 4
        nm[r:r + 9, c] = 30
    nm[4, 4] = 200
    return nm


def _spiral():
    """Inward 40x40 spiral, one connected chain, strong seed at its centre
    end: every turn reverses the direction of the flood."""
    nm = np.zeros((40, 40), np.int16)
    r0, c0, r1, c1 = 0, 0, 39, 39
    pts = []
    while r0 <= r1 and c0 <= c1:
        pts += [(r0, c) for c in range(c0, c1 + 1)]
        pts += [(r, c1) for r in range(r0 + 1, r1 + 1)]
        if r0 < r1:
            pts += [(r1, c) for c in range(c1 - 1, c0 - 1, -1)]
        if c0 < c1:
            pts += [(r, c0) for r in range(r1 - 1, r0 + 1, -1)]
            pts.append((r0 + 2, c0 + 1))   # the step onto the next ring
        r0, c0, r1, c1 = r0 + 2, c0 + 2, r1 - 2, c1 - 2
    for p in pts:
        nm[p] = 30
    nm[pts[-1]] = 200
    return nm


def _rand_nm(h, w, seed):
    rng = np.random.default_rng(seed)
    nm = rng.integers(0, 100, (h, w)).astype(np.int16)
    nm[rng.random((h, w)) < 0.45] = 0
    return nm


def _jax(fn, nm, *args, **kw):
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.jit(
        lambda x: fn(x.astype(jnp.int32), *args, **kw))(nm))


# ---------------------------------------------------------------------------
# plain K3 / K4 against the JAX engines (Pallas, interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thresholds,tile", [((50, 150), (32, 128)),
                                             ((2, 10), (64, 128))])
def test_dilate_plain_vs_pallas(thresholds, tile):
    from canny_edge_tpu.kernels import hysteresis_pallas

    nm = _nm(96, 128)
    ref = _jax(hysteresis_pallas, nm, *thresholds, tile=tile)
    out = dilate.hysteresis_dilate(torch.from_numpy(nm), *thresholds, tile=tile)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


def test_dilate_plain_snake_vs_pallas():
    from canny_edge_tpu.kernels import hysteresis_pallas

    nm = _snake(128, 256)
    ref = _jax(hysteresis_pallas, nm, 10, 100, tile=(32, 128))
    out, sweeps = dilate.hysteresis_dilate(torch.from_numpy(nm), 10, 100,
                                           tile=(32, 128), return_sweeps=True)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref == 255).sum() > 1000 and sweeps > 2


@pytest.mark.parametrize("thresholds,band_h", [((50, 150), 16), ((2, 10), 64)])
def test_banded_plain_vs_pallas(thresholds, band_h):
    from canny_edge_tpu.kernels.hysteresis_v2 import hysteresis_banded

    nm = _nm(96, 128, seed=1)
    ref = _jax(hysteresis_banded, nm, *thresholds, band_h=band_h)
    out = banded.hysteresis_banded(torch.from_numpy(nm), *thresholds,
                                   band_h=band_h)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


def test_banded_plain_spiral_vs_pallas():
    from canny_edge_tpu.kernels.hysteresis_v2 import hysteresis_banded

    nm = _spiral()
    ref = _jax(hysteresis_banded, nm, 10, 100, band_h=16)
    out = banded.hysteresis_banded(torch.from_numpy(nm), 10, 100, band_h=16)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref == 255).sum() > 400


# ---------------------------------------------------------------------------
# plain K3 / K4 against the NumPy oracle (fast fuzz)
# ---------------------------------------------------------------------------

FUZZ_SHAPES = [(1, 1), (1, 50), (40, 1), (7, 33), (33, 31), (20, 64),
               (64, 65), (96, 128), (130, 300)]


@pytest.mark.parametrize("shape", FUZZ_SHAPES)
def test_engines_plain_fuzz_vs_golden(shape):
    h, w = shape
    for k, (mn, mx) in enumerate([(0, 40), (30, 90), (10, 20), (60, 99)]):
        nm = _rand_nm(h, w, seed=100 * h + w + k)
        ref = golden.hysteresis(nm, mn, mx)
        t = torch.from_numpy(nm)
        for tile in [(128, 512), (8, 32), (16, 100)]:
            np.testing.assert_array_equal(
                dilate.hysteresis_dilate(t, mn, mx, tile=tile).numpy(), ref,
                err_msg=f"dilate {shape} {mn}/{mx} tile {tile}")
        for band_h in [None, 1, 8, 16]:
            np.testing.assert_array_equal(
                banded.hysteresis_banded(t, mn, mx, band_h=band_h).numpy(), ref,
                err_msg=f"banded {shape} {mn}/{mx} band_h {band_h}")
        np.testing.assert_array_equal(hysteresis_packed(t, mn, mx).numpy(), ref)


@pytest.mark.parametrize("name", ["snake", "spiral"])
def test_engines_plain_chains_vs_golden(name):
    nm = _snake(128, 256) if name == "snake" else _spiral()
    ref = golden.hysteresis(nm, 10, 100)
    t = torch.from_numpy(nm)
    np.testing.assert_array_equal(dilate.hysteresis_dilate(
        t, 10, 100, tile=(32, 128)).numpy(), ref)
    np.testing.assert_array_equal(banded.hysteresis_banded(
        t, 10, 100, band_h=16).numpy(), ref)


def test_engines_int32_and_negative_nm():
    """nm is compared signed, whatever its integer type."""
    nm = _rand_nm(30, 70, seed=5).astype(np.int32) - 20
    ref = golden.hysteresis(nm, 0, 40)
    for t in (torch.from_numpy(nm), torch.from_numpy(nm.astype(np.int16))):
        for fn in (dilate.hysteresis_dilate, banded.hysteresis_banded,
                   hysteresis_packed, hysteresis_packed_nm):
            np.testing.assert_array_equal(fn(t, 0, 40).numpy(), ref)


def test_engines_sweep_counts():
    """Tiles and bands change the sweep count, never the result."""
    t = torch.from_numpy(_snake(128, 256))
    _, big = dilate.hysteresis_dilate(t, 10, 100, return_sweeps=True)
    _, small = dilate.hysteresis_dilate(t, 10, 100, tile=(32, 128),
                                        return_sweeps=True)
    assert big == 2 and small > big
    _, one = banded.hysteresis_banded(t, 10, 100, return_sweeps=True)
    _, many = banded.hysteresis_banded(t, 10, 100, band_h=16,
                                       return_sweeps=True)
    assert one == 1 and many > one


def test_plain_packed_vs_xla():
    from canny_edge_tpu.ops.packed import hysteresis_packed as jax_packed

    nm = _nm(64, 96, seed=2)
    for strict in (False, True):
        ref = _jax(jax_packed, nm, 30, 90, strict=strict)
        np.testing.assert_array_equal(
            hysteresis_packed(torch.from_numpy(nm), 30, 90, strict=strict).numpy(),
            ref)
        np.testing.assert_array_equal(hysteresis_packed_nm(
            torch.from_numpy(nm), 30, 90, strict=strict).numpy(), ref)


def test_band_and_tile_params():
    assert banded.band_params(1080, 1920) == (64, 7)
    assert banded.band_params(100, 50) == (100, 1)
    assert banded.band_params(5, 50, band_h=64) == (8, 1)
    assert banded.band_params(1080, 1920, band_h=32, group=100) == (32, 34)
    assert dilate.tile_shape(1080, 1920) == (128, 512)
    assert dilate.tile_shape(5, 40) == (8, 128)
    for kw in ({"band_h": 0}, {"group": 0}):
        with pytest.raises(ValueError):
            banded.band_params(64, 64, **kw)
    with pytest.raises(ValueError):
        dilate.tile_shape(64, 64, (0, 128))


# ---------------------------------------------------------------------------
# wrappers on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_cpu_use_plain():
    nm = torch.from_numpy(_nm(50, 70))
    before = (k3.launches, k4.launches)
    a, sa = k3.hysteresis_dilate(nm, 30, 90, tile=(16, 128), return_sweeps=True)
    b, sb = dilate.hysteresis_dilate(nm, 30, 90, tile=(16, 128),
                                     return_sweeps=True)
    assert torch.equal(a, b) and sa == sb
    a, sa = k4.hysteresis_banded(nm, 30, 90, band_h=8, group=3,
                                 return_sweeps=True)
    b, sb = banded.hysteresis_banded(nm, 30, 90, band_h=8, return_sweeps=True)
    assert torch.equal(a, b) and sa == sb
    assert (k3.launches, k4.launches) == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.float32),
                                 np.zeros((2, 2, 4, 4), np.int16),
                                 np.zeros((0, 4), np.int16),
                                 np.zeros((4, 4), np.uint8)])
def test_wrappers_reject(bad):
    for fn in (k3.hysteresis_dilate, k4.hysteresis_banded):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(bad), 1, 2)


# ---------------------------------------------------------------------------
# canny_fused and the model's backends against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_canny_fused_vs_jax(impl):
    import jax

    from canny_edge_tpu.kernels.fused import canny_fused as jax_fused

    img = synthetic_image(64, 96, seed=3)
    ref = np.asarray(jax.jit(lambda x: jax_fused(
        x, 30, 90, kernel_vals=kv(1.4), hysteresis_impl=impl))(img))
    out = canny_fused(torch.from_numpy(img), 30, 90, kernel_vals=kv(1.4),
                      hysteresis_impl=impl)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)
    # every engine gives the same edges, batched frame by frame too
    frames = torch.from_numpy(np.stack([img, synthetic_image(64, 96, seed=4)]))
    out = canny_fused(frames, 30, 90, kernel_vals=kv(1.4), tile=(16, 128),
                      hysteresis_impl=impl)
    for f, o in zip(frames.numpy(), out.numpy()):
        np.testing.assert_array_equal(o, golden.canny(f, 1.4, 30, 90))


def test_canny_fused_strict_and_names():
    from canny_edge_tpu.kernels.fused import canny_fused as jax_fused

    img = np.zeros((16, 64), np.uint8)
    img[1, 0] = 255
    for impl in ("banded", "dilate"):
        with pytest.raises(ValueError) as ours:
            canny_fused(torch.from_numpy(img), 5, 60, kernel_vals=kv(1.0),
                        hysteresis_impl=impl, strict=True)
        with pytest.raises(ValueError) as theirs:
            jax_fused(img, 5, 60, kernel_vals=kv(1.0), hysteresis_impl=impl,
                      strict=True)
        assert str(ours.value) == str(theirs.value)
    nm = golden.nonmax_suppression(*golden.sobel(golden.gaussian_blur(img, 1.0)))
    for impl in ("packed", "packed-xla"):
        out = canny_fused(torch.from_numpy(img), 5, 60, kernel_vals=kv(1.0),
                          hysteresis_impl=impl, strict=True)
        np.testing.assert_array_equal(out.numpy(),
                                      golden.hysteresis_strict(nm, 5, 60))
    with pytest.raises(ValueError, match="unknown hysteresis_impl"):
        canny_fused(torch.from_numpy(img), 5, 60, kernel_vals=kv(1.0),
                    hysteresis_impl="bfs")
    with pytest.raises(ValueError, match="unknown backend"):
        CannyTorch(1.0, device="cpu", backend="triton")
    with pytest.raises(ValueError, match="unknown backend"):
        CannyTorch.from_numpy_params(np.ones(3, np.float32) / 3, device="cpu",
                                     backend="")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_SHAPES = [(1, 1), (1, 1000), (40, 1), (64, 31), (64, 32), (64, 33),
               (64, 63), (64, 65), (257, 333), (300, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_engine_kernels_vs_plain(cuda_device, shape):
    h, w = shape
    for mn, mx in [(0, 40), (30, 90)]:
        nm = torch.from_numpy(_rand_nm(h, w, seed=h + w + mn)).to(cuda_device)
        for tile in [(128, 512), (32, 100)]:
            a, sa = k3.hysteresis_dilate(nm, mn, mx, tile=tile, return_sweeps=True)
            b, sb = dilate.hysteresis_dilate(nm, mn, mx, tile=tile,
                                             return_sweeps=True)
            assert torch.equal(a, b) and sa == sb, (tile, mn)
        for band_h in [None, 16]:
            a, sa = k4.hysteresis_banded(nm, mn, mx, band_h=band_h,
                                         return_sweeps=True)
            b, sb = banded.hysteresis_banded(nm, mn, mx, band_h=band_h,
                                             return_sweeps=True)
            assert torch.equal(a, b) and sa == sb, (band_h, mn)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["snake", "spiral"])
def test_engine_kernels_chains(cuda_device, name):
    nm = _snake(128, 256) if name == "snake" else _spiral()
    ref = torch.from_numpy(golden.hysteresis(nm, 10, 100)).to(cuda_device)
    t = torch.from_numpy(nm).to(cuda_device)
    assert torch.equal(k3.hysteresis_dilate(t, 10, 100, tile=(32, 128)), ref)
    assert torch.equal(k4.hysteresis_banded(t, 10, 100, band_h=16), ref)


@pytest.mark.cuda
def test_engine_kernels_shared_memory_limit(cuda_device):
    nm = torch.zeros((600, 8192), dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        k3.hysteresis_dilate(nm, 1, 2, tile=(600, 8192))
    with pytest.raises(ValueError, match="shared memory"):
        k4.hysteresis_banded(nm, 1, 2, band_h=600)
    # the default band (the whole image below 512 rows) is halved to fit
    tall = torch.from_numpy(_rand_nm(500, 1920, seed=9)).to(cuda_device)
    assert torch.equal(k4.hysteresis_banded(tall, 30, 90),
                       banded.hysteresis_banded(tall, 30, 90))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_model_backend_card_vs_cpu(cuda_device, backend, test_image):
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp

    card = CannyTorch(1.4, backend=backend)
    cpu = CannyTorch(1.4, device="cpu", backend=backend)
    before = (kfe.launches, khp.launches)
    assert torch.equal(card(test_image, 30, 90).cpu(), cpu(test_image, 30, 90))
    after = (kfe.launches - before[0], khp.launches - before[1])
    assert after == ((1, 1) if backend == "pallas" else (0, 0))
    for impl in IMPLS:
        out = canny_fused(torch.from_numpy(test_image).to(cuda_device), 30, 90,
                          kernel_vals=kv(1.4), hysteresis_impl=impl)
        assert torch.equal(out.cpu(), cpu(test_image, 30, 90))
