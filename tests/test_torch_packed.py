"""PyTorch port, packed masks and the plain packed flood (K2's plain
version) against the JAX package, bit for bit: the pack helpers, each flood
operator, and the fixed point against the Pallas flood (interpret mode) and
the XLA flood, in component and strict mode.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.ops import packed as P


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


WIDTHS = [1, 31, 32, 33, 70]


def _rand_mask(shape, density, seed):
    return np.random.default_rng(seed).random(shape) < density


def _pack_np(mask):
    return P.pack_mask(torch.from_numpy(mask)).numpy()


def _masks(shape, density=0.55, seed=0, strong_frac=0.02):
    weak = _rand_mask(shape, density, seed)
    strong = weak & _rand_mask(shape, strong_frac, seed + 1)
    return _pack_np(weak), _pack_np(strong), shape[1]


def _snake(h, w):
    nm = np.zeros((h, w), np.int32)
    for r in range(4, h - 4, 8):
        nm[r, 4:w - 4] = 30
    for i, r in enumerate(range(4, h - 12, 8)):
        c = w - 5 if i % 2 == 0 else 4
        nm[r:r + 9, c] = 30
    nm[4, 4] = 200
    return _pack_np(nm >= 10), _pack_np(nm >= 100), w


def _quirk():
    """Weak run on row 0 reachable only through (1,0) -> (0,1)."""
    nm = np.zeros((16, 64), np.int32)
    nm[1, 0] = 10
    nm[0, 1:10] = 3
    nm[8, 40] = 10
    nm[8, 30:60] = 5
    return _pack_np(nm >= 2), _pack_np(nm >= 10), 64


@pytest.mark.parametrize("w", WIDTHS)
def test_pack_unpack_vs_jax(w):
    import jax

    from canny_edge_tpu.ops.packed import pack_mask, unpack_edges_np

    mask = _rand_mask((9, w), 0.5, w)
    packed = P.pack_mask(torch.from_numpy(mask))
    assert packed.dtype == torch.uint32
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax.jit(pack_mask)(mask)))
    np.testing.assert_array_equal(P.unpack_mask(packed, w).numpy(), mask)
    ref = unpack_edges_np(packed.numpy(), w)
    np.testing.assert_array_equal(P.unpack_edges_np(packed.numpy(), w), ref)
    np.testing.assert_array_equal(P.unpack_edges(packed, w).numpy(), ref)


def test_words_roundtrip_high_bit():
    vals = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    u = torch.from_numpy(vals)
    x = P.from_words(u)
    assert x.dtype == torch.int64 and x.tolist() == vals.tolist()
    np.testing.assert_array_equal(P.to_words(x).numpy(), vals)


@pytest.mark.parametrize("shape", [(7, 33), (16, 96), (3, 1)])
def test_flood_operators_vs_jax(shape):
    from canny_edge_tpu.ops import packed as J

    h, w = shape
    weak, _, _ = _masks(shape, 0.6, 3, 0.2)
    e = _pack_np(_rand_mask(shape, 0.3, 4)) & weak
    tw, te = P.from_words(torch.from_numpy(weak)), P.from_words(torch.from_numpy(e))

    def same(ours, ref):
        np.testing.assert_array_equal(P.to_words(ours).numpy(), np.asarray(ref))

    same(P.dilate_packed(te, tw), J.dilate_packed(e, weak))
    same(P.hflood(te, tw, w), J.hflood(e, weak, w))
    same(P.vflood(te, tw, h), J.vflood(e, weak, h))
    if h >= 2:
        d = J.dilate_packed(e, weak)
        same(P.strict_fix_packed(P.dilate_packed(te, tw), te, tw),
             J.strict_fix_packed(d, e, weak))


def _cases():
    return {
        "random_64x250": _masks((64, 250), 0.55, 0),
        "dense_40x100": _masks((40, 100), 0.7, 5, 0.005),
        "snake_128x256": _snake(128, 256),
        "w33": _masks((48, 33), 0.6, 1),
        "h1": _masks((1, 300), 0.8, 2, 0.05),
        "w1": _masks((60, 1), 0.8, 3, 0.05),
        "quirk_16x64": _quirk(),
    }


CASES = list(_cases())


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_flood_plain_vs_jax(case, strict):
    from canny_edge_tpu.kernels.hysteresis_packed import (
        hysteresis_packed_pallas_masks)
    from canny_edge_tpu.ops.packed import hysteresis_packed_masks

    weak, strong, w = _cases()[case]
    h = weak.shape[0]
    ours, _ = P.hysteresis_packed_masks(torch.from_numpy(weak),
                                        torch.from_numpy(strong), h, w,
                                        strict=strict)
    pallas = np.asarray(hysteresis_packed_pallas_masks(
        weak, strong, h, w, strict=strict, interpret=True))
    xla, _ = hysteresis_packed_masks(weak, strong, h, w, strict=strict)
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(xla))
    if case == "quirk_16x64":
        assert bool(ours.numpy()[0, 0] & 2) == (not strict)


def test_flood_plain_inner_dilate_invariant():
    weak, strong, _ = _masks((64, 200), 0.6, 9)
    args = (torch.from_numpy(weak), torch.from_numpy(strong), 64, 200)
    a, ra = P.hysteresis_packed_masks(*args, inner_dilate=1)
    b, rb = P.hysteresis_packed_masks(*args, inner_dilate=7)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert ra >= rb


def test_flood_wrapper_cpu_uses_plain():
    weak, strong, _ = _masks((40, 70), 0.6, 4)
    before = khp.launches
    out = khp.hysteresis_packed(torch.from_numpy(weak), torch.from_numpy(strong),
                                40, 70)
    ref, _ = P.hysteresis_packed_masks(torch.from_numpy(weak),
                                       torch.from_numpy(strong), 40, 70)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert khp.launches == before


def test_flood_wrapper_rejects():
    weak = torch.zeros((4, 2), dtype=torch.uint32)
    with pytest.raises(ValueError):
        khp.hysteresis_packed(weak, weak, 4, 100)          # wrong word count
    with pytest.raises(ValueError):
        khp.hysteresis_packed(weak.view(torch.int32), weak, 4, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_flood_kernel_vs_plain(cuda_device, case, strict):
    weak, strong, w = _cases()[case]
    weak, strong = (torch.from_numpy(m).to(cuda_device) for m in (weak, strong))
    h = weak.shape[0]
    out = khp.hysteresis_packed(weak, strong, h, w, strict=strict)
    ref, _ = P.hysteresis_packed_masks(weak, strong, h, w, strict=strict)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
