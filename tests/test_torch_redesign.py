"""PyTorch port, the redesigned K1 and K2: the plain mirror of K2's
dirty-tile schedule, K2's NMS-map and int16 modes, the plain front end at
every window the kernel specialises, and ``canny_fused(device=)``, against
the JAX package on the CPU; on the card the kernels against their plain
versions.  Tolerance: 0 (integer outputs, bit-equal) everywhere.

Inputs are made from NumPy seeds and cross between the frameworks as NumPy
arrays; JAX runs on the CPU and its Pallas kernels in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu.golden.reference import gaussian_kernel as golden_kernel
from canny_edge_tpu.io.imageio import synthetic_image
from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.kernels.fused import canny_fused
from canny_edge_tpu_torch.ops import gaussian, window
from canny_edge_tpu_torch.ops import packed as P
from canny_edge_tpu_torch.ops import packed_tiles as T


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


SHAPES = [(1, 1), (1, 1000), (40, 1), (64, 33), (257, 333)]
TILES = [(8, 32), (4, 3)]
# one sigma per window the kernel unrolls (3..15) and one generic (19)
WINDOW_SIGMAS = {3: 0.3, 5: 0.5, 7: 1.0, 9: 1.2, 11: 1.4, 13: 2.0, 15: 2.3,
                 19: 3.0}


def _rand_nm(h, w, seed):
    rng = np.random.default_rng(seed)
    nm = rng.integers(0, 100, (h, w)).astype(np.int16)
    nm[rng.random((h, w)) < 0.45] = 0
    return nm


def _snake(h, w):
    """Serpentine weak chain with one strong seed: many tile crossings."""
    nm = np.zeros((h, w), np.int16)
    for r in range(4, h - 4, 8):
        nm[r, 4:w - 4] = 30
    for i, r in enumerate(range(4, h - 12, 8)):
        c = w - 5 if i % 2 == 0 else 4
        nm[r:r + 9, c] = 30
    nm[4, 4] = 200
    return nm


def _spiral(n=40):
    """Inward spiral, one connected chain, strong seed at its centre end."""
    nm = np.zeros((n, n), np.int16)
    r0, c0, r1, c1 = 0, 0, n - 1, n - 1
    pts = []
    while r0 <= r1 and c0 <= c1:
        pts += [(r0, c) for c in range(c0, c1 + 1)]
        pts += [(r, c1) for r in range(r0 + 1, r1 + 1)]
        if r0 < r1:
            pts += [(r1, c) for c in range(c1 - 1, c0 - 1, -1)]
        if c0 < c1:
            pts += [(r, c0) for r in range(r1 - 1, r0 + 1, -1)]
            pts.append((r0 + 2, c0 + 1))
        r0, c0, r1, c1 = r0 + 2, c0 + 2, r1 - 2, c1 - 2
    for p in pts:
        nm[p] = 30
    nm[pts[-1]] = 200
    return nm


def _quirk():
    """Weak run on row 0 reachable only through (1,0) -> (0,1)."""
    nm = np.zeros((16, 64), np.int16)
    nm[1, 0] = 100
    nm[0, 1:10] = 30
    nm[8, 40] = 100
    nm[8, 30:60] = 50
    return nm


def _case(name):
    """name -> (nm int16, min_val, max_val)."""
    if name == "snake":
        return _snake(128, 256), 10, 100
    if name == "spiral":
        return _spiral(), 10, 100
    if name == "quirk":
        return _quirk(), 20, 90
    h, w = (int(v) for v in name.split("x"))
    return _rand_nm(h, w, seed=7 * h + w), 30, 90


CASES = [f"{h}x{w}" for h, w in SHAPES] + ["snake", "spiral", "quirk"]


def _masks(name):
    nm, lo, hi = _case(name)
    t = torch.from_numpy(nm)
    return P.pack_mask(t >= lo), P.pack_mask(t >= hi), nm.shape


@functools.lru_cache(maxsize=None)
def _jax_masks(name, strict):
    """The JAX package's XLA packed flood on the case's masks."""
    from canny_edge_tpu.ops.packed import hysteresis_packed_masks

    weak, strong, (h, w) = _masks(name)
    out, _ = hysteresis_packed_masks(weak.numpy(), strong.numpy(), h, w,
                                     strict=strict)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# the dirty-tile mirror against the JAX flood
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", CASES)
def test_tile_mirror_vs_jax(case, tile, strict):
    weak, strong, (h, w) = _masks(case)
    out, steps, floods = T.hysteresis_packed_tiles(weak, strong, h, w,
                                                   tile=tile, strict=strict)
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.numpy(), _jax_masks(case, strict))
    ntiles = P.cdiv(h, tile[0]) * P.cdiv(P.cdiv(w, 32), tile[1])
    assert steps >= 1 and floods >= ntiles        # step 0 floods every tile
    if ntiles == 1:
        assert (steps, floods) == (1, 1)
    if case == "quirk":
        assert bool(out.numpy()[0, 0] & 2) == (not strict)


def test_tile_mirror_worklist_is_sparse():
    """On a long chain the later steps flood the front, not every tile."""
    weak, strong, (h, w) = _masks("snake")
    _, steps, floods = T.hysteresis_packed_tiles(weak, strong, h, w,
                                                 tile=(8, 2))
    ntiles = P.cdiv(h, 8) * P.cdiv(P.cdiv(w, 32), 2)
    assert steps > 10
    assert floods < ntiles + 9 * steps            # at most a 3x3 block a step
    _, small_steps, _ = T.hysteresis_packed_tiles(weak, strong, h, w,
                                                  tile=(16, 8))
    assert small_steps < steps                    # larger tiles, fewer steps


def test_tile_mirror_rejects():
    weak, strong, (h, w) = _masks("64x33")
    with pytest.raises(ValueError):
        T.hysteresis_packed_tiles(weak, strong, h, w, tile=(0, 32))
    with pytest.raises(ValueError):
        T.hysteresis_packed_tiles(weak, strong, h, w, tile=(1, 32), strict=True)


# ---------------------------------------------------------------------------
# K2's NMS-map input and int16 output, plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", ["64x33", "quirk", "spiral"])
def test_nm_int16_plain_vs_pallas(case, strict):
    import jax
    import jax.numpy as jnp

    from canny_edge_tpu.kernels.hysteresis_packed import hysteresis_packed_pallas

    nm, lo, hi = _case(case)
    ref = np.asarray(jax.jit(lambda x: hysteresis_packed_pallas(
        x.astype(jnp.int32), lo, hi, strict=strict, interpret=True))(nm))
    before = khp.launches, dict(P.calls)
    out = khp.hysteresis_packed_nm(torch.from_numpy(nm), lo, hi, strict=strict)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)
    assert khp.launches == before[0]              # the CPU launches no kernel
    assert P.calls["pack_mask"] == before[1]["pack_mask"] + 2   # but packs
    # the other three mode combinations give the same edges
    weak, strong, (h, w) = _masks(case)
    packed = khp.hysteresis_packed_nm(torch.from_numpy(nm), lo, hi,
                                      strict=strict, packed_out=True)
    assert packed.dtype == torch.uint32
    np.testing.assert_array_equal(P.unpack_edges(packed, w).numpy(), ref)
    np.testing.assert_array_equal(packed.numpy(), khp.hysteresis_packed(
        weak, strong, h, w, strict=strict).numpy())
    np.testing.assert_array_equal(khp.hysteresis_packed(
        weak, strong, h, w, strict=strict, edges_int16=True).numpy(), ref)


def test_nm_modes_batch_steps_and_rejects():
    nm = torch.from_numpy(np.stack([_rand_nm(20, 70, 1), _rand_nm(20, 70, 2)]))
    out = khp.hysteresis_packed_nm(nm, 30, 90)
    assert out.shape == (2, 20, 70) and out.dtype == torch.int16
    for f, o in zip(nm, out):
        assert torch.equal(o, P.hysteresis_packed(f, 30, 90))
    one, steps = khp.hysteresis_packed_nm(nm[0].to(torch.int32), 30, 90,
                                          return_steps=True)
    assert torch.equal(one, out[0]) and steps >= 1
    with pytest.raises(ValueError):
        khp.hysteresis_packed_nm(nm, 30, 90, return_steps=True)
    for bad in (torch.zeros((4, 4)), torch.zeros((0, 4), dtype=torch.int16),
                torch.zeros(4, dtype=torch.int16)):
        with pytest.raises(ValueError):
            khp.hysteresis_packed_nm(bad, 1, 2)


# ---------------------------------------------------------------------------
# the plain front end at every window the kernel specialises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win", list(WINDOW_SIGMAS))
def test_frontend_plain_each_window_vs_jax(win):
    import jax

    from canny_edge_tpu.ops.window import frontend_nm_xla

    sigma = WINDOW_SIGMAS[win]
    k = gaussian.gaussian_kernel(sigma)
    assert len(k) == win
    img = synthetic_image(70, 131, seed=win)
    kv = tuple(float(v) for v in golden_kernel(sigma))
    ref = np.asarray(jax.jit(lambda x: frontend_nm_xla(x, kv))(img))
    nm = window.frontend_nm(torch.from_numpy(img), k)
    np.testing.assert_array_equal(nm.numpy(), ref)
    weak, strong = kfe.frontend(torch.from_numpy(img), torch.from_numpy(k),
                                (30, 90))
    np.testing.assert_array_equal(weak.numpy(), P.pack_mask(nm >= 30).numpy())
    np.testing.assert_array_equal(strong.numpy(), P.pack_mask(nm >= 90).numpy())


EXTREME_THRESHOLDS = [(-2**31, 2**31 - 1), (-5, 2**29), (2**30, 2**30 + 1),
                      (0, 8192), (-1, 8191)]


@pytest.mark.parametrize("pair", EXTREME_THRESHOLDS)
def test_frontend_threshold_range_plain(pair):
    """Any integer threshold is a plain signed compare with the magnitude."""
    img = torch.from_numpy(synthetic_image(40, 70, seed=9))
    k = gaussian.gaussian_kernel(1.0)
    nm = window.frontend_nm(img, k)
    weak, strong = kfe.frontend(img, torch.from_numpy(k), pair)
    for got, t in zip((weak, strong), pair):
        want = nm.to(torch.int64) >= t
        assert bool(want.all()) == (t <= 0) and (t < 8191 or not want.any())
        np.testing.assert_array_equal(got.numpy(), P.pack_mask(want).numpy())


@pytest.mark.parametrize("win", list(WINDOW_SIGMAS))
def test_model_each_window_vs_canny_tpu(win):
    from canny_edge_tpu.models import CannyTPU

    sigma = WINDOW_SIGMAS[win]
    img = synthetic_image(64, 96, seed=win)
    ref = np.asarray(CannyTPU(sigma=sigma, backend="fused")(img, 30, 90))
    out = CannyTorch(sigma, device="cpu")(img, 30, 90)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# canny_fused(device=): where a NumPy frame runs
# ---------------------------------------------------------------------------

def test_canny_fused_device_argument():
    img = synthetic_image(48, 80, seed=5)
    kv = tuple(float(v) for v in golden_kernel(1.0))
    want = CannyTorch(1.0, device="cpu")(img, 30, 90)
    # a NumPy frame with device="cpu" runs the plain versions
    out = canny_fused(img, 30, 90, kernel_vals=kv, device="cpu")
    assert out.device.type == "cpu" and torch.equal(out, want)
    # a CPU tensor stays on the CPU whatever `device` says
    out = canny_fused(torch.from_numpy(img), 30, 90, kernel_vals=kv)
    assert out.device.type == "cpu" and torch.equal(out, want)
    # a NumPy frame goes to the card by default, and raises without one
    if torch.cuda.is_available():
        out = canny_fused(img, 30, 90, kernel_vals=kv)
        assert out.device.type == "cuda" and torch.equal(out.cpu(), want)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            canny_fused(img, 30, 90, kernel_vals=kv)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CannyTorch(1.0)


# ---------------------------------------------------------------------------
# tools/sass_loops.py: the loop listing PERF.md's instruction counts come from
# ---------------------------------------------------------------------------

SASS = """
\tFunction : _Z4demoPi
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0030*/                   LDG.E R2, [R4.64] ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   BRA 0x70 ;
        /*0060*/                   NOP ;
        /*0070*/                   EXIT ;
\tFunction : other
        /*0000*/                   EXIT ;
"""


def test_sass_loops_listing():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "sass_loops.py"
    spec = importlib.util.spec_from_file_location("sass_loops", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    found = tool.kernels(SASS)
    assert list(found) == ["_Z4demoPi", "other"]
    assert len(found["_Z4demoPi"]) == 8 and len(found["other"]) == 1
    (start, end, count, mix), = tool.loops(found["_Z4demoPi"])   # one backward
    assert (start, end, count) == (0x20, 0x40, 3)
    assert mix == {"IADD3": 1, "LDG": 1, "BRA": 1}
    assert tool.loops(found["other"]) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_SHAPES = [(1, 1), (1, 1000), (40, 1), (64, 31), (64, 33), (63, 65),
               (65, 63), (257, 333), (128, 1000), (130, 1921)]


@pytest.mark.cuda
@pytest.mark.parametrize("win", list(WINDOW_SIGMAS))
def test_frontend_kernel_each_window(cuda_device, win):
    k = gaussian.gaussian_kernel(WINDOW_SIGMAS[win])
    taps = torch.from_numpy(k).to(cuda_device)
    for h, w in CARD_SHAPES:
        rng = np.random.default_rng(h * w + win)
        img = torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8))
        img = img.to(cuda_device)
        ref = window.frontend_nm(img, k)
        assert torch.equal(kfe.frontend(img, taps).to(torch.int32), ref), (h, w)
        weak, strong = kfe.frontend(img, taps, (30, 90))
        assert torch.equal(weak.view(torch.int32),
                           P.pack_mask(ref >= 30).view(torch.int32)), (h, w)
        assert torch.equal(strong.view(torch.int32),
                           P.pack_mask(ref >= 90).view(torch.int32)), (h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
def test_flood_kernel_modes_vs_plain(cuda_device, strict):
    names = CASES + [f"{h}x{w}" for h, w in CARD_SHAPES[3:]]
    for name in names:
        nm_np, lo, hi = _case(name)
        h, w = nm_np.shape
        nm = torch.from_numpy(nm_np).to(cuda_device)
        weak, strong = P.pack_mask(nm >= lo), P.pack_mask(nm >= hi)
        ref, _ = P.hysteresis_packed_masks(weak, strong, h, w, strict=strict)
        ref16 = P.unpack_edges(ref, w)
        _, mirror_steps, _ = T.hysteresis_packed_tiles(
            weak.cpu(), strong.cpu(), h, w, tile=T.DEFAULT_TILE, strict=strict)
        kw = {"strict": strict}
        calls = dict(P.calls)
        out, steps = khp.hysteresis_packed(weak, strong, h, w,
                                           return_steps=True, **kw)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), name
        assert 1 <= int(steps) <= mirror_steps, (name, int(steps), mirror_steps)
        assert torch.equal(khp.hysteresis_packed(
            weak, strong, h, w, edges_int16=True, **kw), ref16), name
        for t in (nm, nm.to(torch.int32)):
            assert torch.equal(khp.hysteresis_packed_nm(t, lo, hi, **kw),
                               ref16), name
            assert torch.equal(khp.hysteresis_packed_nm(
                t, lo, hi, packed_out=True, **kw).view(torch.int32),
                ref.view(torch.int32)), name
        assert P.calls == calls, "a plain pack/unpack ran on a kernel path"


@pytest.mark.cuda
def test_frontend_kernel_threshold_range(cuda_device, test_image):
    """Thresholds far outside the magnitudes decide as the plain compare."""
    k = gaussian.gaussian_kernel(1.4)
    taps = torch.from_numpy(k).to(cuda_device)
    img = torch.from_numpy(test_image).to(cuda_device)
    ref = window.frontend_nm(img, k)
    for pair in EXTREME_THRESHOLDS:
        weak, strong = kfe.frontend(img, taps, pair)
        for got, t in zip((weak, strong), pair):
            assert torch.equal(got.view(torch.int32),
                               P.pack_mask(ref >= t).view(torch.int32)), pair


@pytest.mark.cuda
def test_model_card_runs_no_plain_pack(cuda_device, test_image):
    cpu = CannyTorch(1.4, device="cpu")(test_image, 30, 90)
    frame = torch.from_numpy(test_image).to(cuda_device)
    calls = dict(P.calls)
    for backend in ("fused", "pallas"):
        model = CannyTorch(1.4, backend=backend)
        assert torch.equal(model(frame, 30, 90).cpu(), cpu)
        assert torch.equal(model.batch(torch.stack([frame, frame]), 30, 90)[1]
                           .cpu(), cpu)
    for impl in ("packed", "banded", "dilate"):
        out = canny_fused(frame, 30, 90, hysteresis_impl=impl,
                          kernel_vals=gaussian.gaussian_kernel(1.4))
        assert torch.equal(out.cpu(), cpu)
    assert P.calls == calls, "a plain pack/unpack ran on a kernel path"
