"""PyTorch port, the batch path: a ``(B, H, W)`` batch is one launch of each
stage on the card (JAX's ``vmap`` over its Pallas kernels, and its
``lax.map`` over the single-frame pipeline), and on the CPU the wrappers
stack their frames' plain results.  Here: ``canny_fused`` on a batch for
each engine, ``CannyTorch.batch`` / ``batch_packed`` and the functional
entry points against JAX; JAX's vmapped packed flood on a batch of an empty
map, a serpentine chain and a random map; every wrapper's batch against its
frames one by one and what it refuses; ``ops``' ``hysteresis_packed_with_stats``,
``hysteresis_packed``'s positional ``inner_dilate`` and ``shift2d`` against
JAX; on the card, batched kernels against single-frame launches and the
plain versions, with their launch counts.  Tolerance: 0 differing pixels,
equal counts.

Inputs are made from NumPy seeds and cross between the frameworks as NumPy
arrays; JAX runs on the CPU, its Pallas kernels in interpret mode.  Each
JAX reference is computed once a module (``_jax``).
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu.golden.reference import gaussian_kernel
from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch import models
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import hysteresis as k3
from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
from canny_edge_tpu_torch.kernels.fused import IMPLS, canny_fused
from canny_edge_tpu_torch.ops import packed as P
from canny_edge_tpu_torch.ops import shifts

MN, MX = 30, 90
SIGMA = 1.0
_cache = {}


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def kv():
    return tuple(float(v) for v in gaussian_kernel(SIGMA))


def _jax(key, fn):
    """A JAX reference, computed once a module, as a NumPy array."""
    if key not in _cache:
        _cache[key] = np.asarray(fn())
    return _cache[key]


def _frames(b=3, h=24, w=40, seed=0):
    """A batch of random frames with the quirk pixel (1, 0) lit."""
    imgs = np.random.default_rng(seed).integers(0, 256, (b, h, w), np.uint8)
    imgs[:, min(1, h - 1), 0] = 255
    return imgs


def _snake(h, w):
    """Serpentine weak chain with one strong seed."""
    nm = np.zeros((h, w), np.int16)
    for r in range(4, h - 4, 8):
        nm[r, 4:w - 4] = 30
    for i, r in enumerate(range(4, h - 12, 8)):
        nm[r:r + 9, w - 5 if i % 2 == 0 else 4] = 30
    nm[4, 4] = 200
    return nm


def _mixed(h=48, w=140):
    """An empty map, a serpentine chain and a random map: frames that
    converge after very different numbers of steps."""
    rnd = np.random.default_rng(5).integers(0, 100, (h, w)).astype(np.int16)
    rnd[np.random.default_rng(6).random((h, w)) < 0.45] = 0
    return np.stack([np.zeros((h, w), np.int16), _snake(h, w), rnd])


def _fused_ref(imgs):
    """JAX ``canny_fused`` on the batch (``jax.vmap`` of its Pallas
    pipeline, K1 and K2, in interpret mode; jitted, which compiles the
    interpreted kernels once: 4x faster than tracing them eagerly);
    ``CannyTPU(backend="pallas").batch`` is the same function
    (``models/canny.py:199-208``)."""
    import jax

    from canny_edge_tpu.kernels.fused import canny_fused as jax_fused

    return _jax("fused", lambda: jax.jit(lambda x: jax_fused(
        x, MN, MX, kernel_vals=kv()))(imgs))


# ---------------------------------------------------------------------------
# the pipeline and the model on a batch, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_canny_fused_batch_equals_jax(impl):
    imgs = _frames()
    got = canny_fused(torch.from_numpy(imgs), MN, MX, kernel_vals=kv(),
                      hysteresis_impl=impl)
    assert got.shape == imgs.shape and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), _fused_ref(imgs))
    for f, g in zip(imgs, got):
        assert torch.equal(g, canny_fused(torch.from_numpy(f), MN, MX,
                                          kernel_vals=kv(),
                                          hysteresis_impl=impl))


@pytest.mark.parametrize("backend,b,mode", [
    ("fused", 3, "component"), ("pallas", 3, "component"),
    ("xla", 3, "component"), ("fused", 1, "strict-reference")])
def test_model_batch_equals_cannytpu(backend, b, mode):
    from canny_edge_tpu.models import CannyTPU

    imgs = _frames(b)
    model = CannyTorch(SIGMA, hysteresis_mode=mode, device="cpu",
                       backend=backend)
    got = model.batch(imgs, MN, MX)
    if backend == "pallas":
        want = _fused_ref(imgs)
    else:
        ref = CannyTPU(sigma=SIGMA, backend=backend, hysteresis_mode=mode)
        want = _jax(("batch", backend, b, mode),
                    lambda: ref.batch(imgs, MN, MX))
        if backend == "fused":
            # batch_packed runs the fused engines whatever the backend
            packed = _jax(("batch_packed", b, mode),
                          lambda: ref.batch_packed(imgs, MN, MX))
            got_p = model.batch_packed(imgs, MN, MX)
            np.testing.assert_array_equal(got_p.numpy(), packed)
            np.testing.assert_array_equal(models.canny_fn_packed(
                imgs, MN, MX, kernel_vals=kv(), hysteresis_mode=mode,
                device="cpu").numpy(), packed)
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's canny_fn_batched, jitted, is CannyTPU.batch of fused and xla
    np.testing.assert_array_equal(models.canny_fn_batched(
        imgs, MN, MX, kernel_vals=kv(), backend=backend, hysteresis_mode=mode,
        device="cpu").numpy(), want)
    np.testing.assert_array_equal(models.canny_fn(
        imgs, MN, MX, kernel_vals=kv(), backend=backend, hysteresis_mode=mode,
        device="cpu").numpy(), want)


def test_vmapped_flood_equals_jax_on_mixed_batch():
    """JAX's packed flood vmapped over a batch (``kernels/
    hysteresis_packed.py:344-348``) against K2's wrapper on the same batch,
    each frame converging on its own."""
    import jax

    from canny_edge_tpu.kernels.hysteresis_packed import \
        hysteresis_packed_pallas

    nm = _mixed()
    want = _jax("flood", lambda: jax.jit(lambda x: hysteresis_packed_pallas(
        x.astype(np.int32), 10, 100, interpret=True))(nm))
    assert (want[1] == 255).sum() == (nm[1] >= 10).sum()   # the whole chain
    got = khp.hysteresis_packed_nm(torch.from_numpy(nm), 10, 100)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrappers on a batch: the stack of their frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thresholds", [None, (MN, MX)])
def test_frontend_batch_is_its_frames(thresholds):
    imgs = torch.from_numpy(_frames(3, 17, 70))
    taps = torch.tensor(kv(), dtype=torch.float32)
    got = kfe.frontend(imgs, taps, thresholds)
    singles = [kfe.frontend(f, taps, thresholds) for f in imgs]
    if thresholds is None:
        assert torch.equal(got, torch.stack(singles))
    else:
        for i in (0, 1):
            assert torch.equal(got[i], torch.stack([s[i] for s in singles]))
    one = kfe.frontend(imgs[:1], taps, thresholds)        # B = 1
    assert torch.equal(one if thresholds is None else one[0],
                       (got if thresholds is None else got[0])[:1])


@pytest.mark.parametrize("strict", [False, True])
def test_flood_batch_is_its_frames(strict):
    nm = torch.from_numpy(_mixed())
    h, w = nm.shape[-2:]
    weak, strong = P.pack_mask(nm >= 10), P.pack_mask(nm >= 100)
    singles = [khp.hysteresis_packed_nm(f, 10, 100, strict=strict)
               for f in nm]
    want = torch.stack(singles)
    assert torch.equal(khp.hysteresis_packed_nm(nm, 10, 100, strict=strict),
                       want)
    assert torch.equal(P.unpack_edges(khp.hysteresis_packed_nm(
        nm.to(torch.int32), 10, 100, strict=strict, packed_out=True), w),
        want)
    assert torch.equal(khp.hysteresis_packed(weak, strong, h, w,
                                             strict=strict,
                                             edges_int16=True), want)
    assert torch.equal(P.unpack_edges(khp.hysteresis_packed(
        weak, strong, h, w, strict=strict), w), want)


def test_engines_batch_is_its_frames():
    nm = torch.from_numpy(_mixed())
    for fn in (k3.hysteresis_dilate, k4.hysteresis_banded):
        out, sweeps = fn(nm, 10, 100, return_sweeps=True)
        singles = [fn(f, 10, 100, return_sweeps=True) for f in nm]
        assert torch.equal(out, torch.stack([o for o, _ in singles]))
        # the batch sweeps as often as its slowest frame
        assert sweeps == max(s for _, s in singles)
        assert torch.equal(out, khp.hysteresis_packed_nm(nm, 10, 100))


def test_batch_rejects():
    taps = torch.tensor(kv(), dtype=torch.float32)
    for bad in (torch.zeros((0, 8, 8), dtype=torch.uint8),
                torch.zeros((2, 2, 8, 8), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            kfe.frontend(bad, taps)
    for bad in (torch.zeros((0, 8, 8), dtype=torch.int16),
                torch.zeros((2, 2, 8, 8), dtype=torch.int16)):
        for fn in (k3.hysteresis_dilate, k4.hysteresis_banded,
                   khp.hysteresis_packed_nm):
            with pytest.raises(ValueError):
                fn(bad, 1, 2)
    weak = torch.zeros((3, 8, 1), dtype=torch.uint32)
    for other in (weak[:2], weak[0], torch.zeros((3, 8, 2),
                                                  dtype=torch.uint32)):
        with pytest.raises(ValueError):
            khp.hysteresis_packed(weak, other, 8, 20)
    with pytest.raises(ValueError):
        khp.hysteresis_packed(weak[:0], weak[:0], 8, 20)
    with pytest.raises(ValueError):          # the counts stay single-frame
        khp.hysteresis_packed(weak, weak, 8, 20, return_steps=True)
    nm = torch.zeros((2, 8, 8), dtype=torch.int16)
    for stats in (k3.dilate_stats, k4.banded_stats):
        with pytest.raises(ValueError):
            stats(nm, 1, 2)
    with pytest.raises(ValueError):
        models.canny_fn_batched(np.zeros((8, 8), np.uint8), 1, 2,
                                kernel_vals=kv(), device="cpu")


# ---------------------------------------------------------------------------
# the repairs of ops: hysteresis_packed_with_stats, inner_dilate, shift2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(24, 40), (17, 70), (48, 140)])
def test_with_stats_equals_jax(shape):
    from canny_edge_tpu.ops import packed as JP

    if shape == (48, 140):                 # many rounds: a long chain
        nm = _snake(*shape).astype(np.int32)
    else:
        rng = np.random.default_rng(sum(shape))
        nm = rng.integers(0, 100, shape).astype(np.int32)
        nm[rng.random(shape) < 0.45] = 0
    want, rounds = JP.hysteresis_packed_with_stats(nm, MN, MX)
    got, got_rounds = P.hysteresis_packed_with_stats(torch.from_numpy(nm),
                                                     MN, MX)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_rounds == int(rounds)
    if shape == (48, 140):
        # inner_dilate is positional, as in JAX; it changes the rounds only
        want2, rounds2 = JP.hysteresis_packed_with_stats(nm, MN, MX, 2)
        got2, got_rounds2 = P.hysteresis_packed_with_stats(
            torch.from_numpy(nm), MN, MX, 2)
        assert got_rounds2 == int(rounds2)
        np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
        np.testing.assert_array_equal(P.hysteresis_packed(
            torch.from_numpy(nm), MN, MX, 2, True).numpy(),
            np.asarray(JP.hysteresis_packed(nm, MN, MX, 2, True)))


def test_shift2d_equals_jax():
    import jax.numpy as jnp

    from canny_edge_tpu.ops import shifts as JS

    x = np.random.default_rng(2).integers(-50, 50, (2, 9, 13)).astype(
        np.int32)
    for dr, dc, fill in ((1, -2, 0), (-3, 4, 7), (0, 13, -1), (9, 0, 0),
                         (-1, -1, 5)):
        np.testing.assert_array_equal(
            shifts.shift2d(torch.from_numpy(x), dr, dc, fill).numpy(),
            np.asarray(JS.shift2d(jnp.asarray(x), dr, dc, fill)))


# ---------------------------------------------------------------------------
# on the card: batched kernels against single-frame launches and the plain
# versions, and one launch of each stage a batch
# ---------------------------------------------------------------------------

def _cases():
    """(tag, uint8 batch or None, int16 NMS batch): ragged shapes whose
    frames start unaligned, and the mixed batch."""
    rng = np.random.default_rng(11)
    out = []
    for shape in ((3, 257, 333), (3, 1, 1000), (3, 40, 1), (3, 64, 33),
                  (2, 300, 500)):
        nm = rng.integers(0, 100, shape).astype(np.int16)
        nm[rng.random(shape) < 0.45] = 0
        out.append(("x".join(map(str, shape)), _frames(*shape, seed=3), nm))
    out.append(("mixed", None, _mixed()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(6))
def test_card_batch_equals_frames_and_plain(cuda_device, case):
    from canny_edge_tpu_torch.ops import banded, dilate, window

    tag, imgs, nm = _cases()[case]
    taps = torch.tensor(kv(), dtype=torch.float32, device=cuda_device)
    nms = [torch.from_numpy(nm).to(cuda_device)]
    if imgs is not None:
        img = torch.from_numpy(imgs).to(cuda_device)
        k1 = kfe.frontend(img, taps)
        weak, strong = kfe.frontend(img, taps, (MN, MX))
        ref = torch.stack([window.frontend_nm(f, np.asarray(kv(), np.float32))
                           for f in img])
        assert torch.equal(k1, torch.stack([kfe.frontend(f, taps)
                                            for f in img])), tag
        assert torch.equal(k1.to(torch.int32), ref), tag
        assert torch.equal(weak.view(torch.int32),
                           P.pack_mask(ref >= MN).view(torch.int32)), tag
        assert torch.equal(strong.view(torch.int32),
                           P.pack_mask(ref >= MX).view(torch.int32)), tag
        nms.append(k1)
    for m in nms:
        h, w = m.shape[-2:]
        for strict in (False, True):
            want = torch.stack([P.hysteresis_packed(f, MN, MX, strict=strict)
                                for f in m])
            assert torch.equal(khp.hysteresis_packed_nm(m, MN, MX,
                                                        strict=strict), want)
            assert torch.equal(khp.hysteresis_packed(
                P.pack_mask(m >= MN), P.pack_mask(m >= MX), h, w,
                strict=strict, edges_int16=True), want), (tag, strict)
            assert torch.equal(torch.stack([khp.hysteresis_packed_nm(
                f, MN, MX, strict=strict) for f in m]), want)
        for fn, plain in ((k3.hysteresis_dilate, dilate.hysteresis_dilate),
                          (k4.hysteresis_banded, banded.hysteresis_banded)):
            out, sweeps = fn(m, MN, MX, return_sweeps=True)
            singles = [fn(f, MN, MX, return_sweeps=True) for f in m]
            assert torch.equal(out, torch.stack([o for o, _ in singles]))
            assert sweeps == max(s for _, s in singles), tag
            if tag != "mixed" and h < 200:
                assert torch.equal(out, torch.stack([plain(f, MN, MX)
                                                     for f in m])), tag
            assert torch.equal(out, khp.hysteresis_packed_nm(m, MN, MX)), tag


@pytest.mark.cuda
def test_card_batch_is_one_launch_a_stage(cuda_device):
    imgs = torch.from_numpy(_frames(4, 120, 200, seed=9)).to(cuda_device)
    taps = torch.tensor(kv(), dtype=torch.float32, device=cuda_device)
    mods = {"k1": kfe, "k2": khp, "k3": k3, "k4": k4}
    fused = CannyTorch(SIGMA)
    runs = [(lambda: fused.batch(imgs, MN, MX), {"k1", "k2"}),
            (lambda: fused.batch_packed(imgs, MN, MX), {"k1", "k2"}),
            (lambda: CannyTorch(SIGMA, backend="pallas").batch(imgs, MN, MX),
             {"k1", "k2"})]
    for impl, engine in (("packed", "k2"), ("banded", "k4"),
                         ("dilate", "k3"), ("packed-xla", None)):
        runs.append((lambda impl=impl: canny_fused(
            imgs, MN, MX, kernel_vals=taps, hysteresis_impl=impl),
            {"k1"} | ({engine} if engine else set())))
    want = fused.batch(imgs, MN, MX)
    for fn, stages in runs:
        before = {k: (m.launches, m.batch_launches) for k, m in mods.items()}
        out = fn()
        for k, m in mods.items():
            n = int(k in stages)
            assert (m.launches, m.batch_launches) == (
                before[k][0] + n, before[k][1] + n), k
        if out.dtype == torch.uint32:
            out = P.unpack_edges(out, imgs.shape[-1])
        assert torch.equal(out, want)
    assert torch.equal(want, torch.stack([fused(f, MN, MX) for f in imgs]))
