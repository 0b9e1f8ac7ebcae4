"""PyTorch port: inputs at the edge of and past the data contract.

The contract is a uint8 ``(H, W)`` frame (or a ``(B, H, W)`` batch) and
float32 Gaussian taps (``ROADMAP.md``; JAX's docstrings).

At its edge, frames without a pixel: JAX's functional entry points return an
empty map for a frame of no rows on ``xla`` and ``fused`` (a batch of such
frames too, and ``canny_fn_packed`` its empty words), and for a batch of no
frames on every backend; they refuse a width of 0 on every backend and no
rows on ``pallas``.  The port does the same on the input's device, with no
kernel launch and no plain front end.

Past it (``ROADMAP.md`` §C records both as divergences, not faults):
frames of other dtypes run on ``xla`` as JAX's ``xla`` runs them, and the
``fused`` and ``pallas`` backends refuse them; a blur outside [0, 255] (a
signed frame, or a negative tap) differs from JAX on the CPU because JAX's
product helper there (``canny_edge_tpu/ops/numerics.py:exact_mul_const_f32``,
whose precondition is x >= 0 and w > 0) returns |x w|, where the port rounds
the IEEE product; its divisions agree with IEEE on the same accumulators.
The counts and first differing pixels are the ones §C records.

Tolerance: 0 differing pixels, except the recorded divergence counts, which
are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from bench_torch import make_image
from canny_edge_tpu.models import CannyTPU
from canny_edge_tpu.models import canny as jax_canny
from canny_edge_tpu.ops import numerics as jax_numerics
from canny_edge_tpu.ops import window as jax_window
from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.models import canny as port_canny
from canny_edge_tpu_torch.ops import window as port_window
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

K14 = gaussian_kernel(1.4)
MN, MX = 30, 90


def _run(fn):
    """``fn()`` as a NumPy array, or the exception it raised."""
    try:
        out = fn()
    except Exception as e:      # noqa: BLE001  (either side may refuse)
        return e
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


EMPTY_CASES = [
    # (entry point, backend, shape)
    ("canny_fn", "xla", (0, 40)),
    ("canny_fn", "fused", (0, 40)),
    ("canny_fn", "pallas", (0, 40)),
    ("canny_fn", "xla", (40, 0)),
    ("canny_fn", "fused", (0, 0)),
    ("canny_fn_packed", None, (0, 40)),
    ("canny_fn_packed", None, (40, 0)),
    ("canny_fn_batched", "xla", (2, 0, 40)),
    ("canny_fn_batched", "fused", (2, 0, 40)),
    ("canny_fn_batched", "pallas", (2, 0, 40)),
    ("canny_fn_batched", "fused", (0, 30, 40)),
    ("canny_fn_batched", "pallas", (0, 30, 40)),
    ("canny_fn_batched", "xla", (2, 40, 0)),
]


@pytest.mark.parametrize("entry,backend,shape", EMPTY_CASES)
def test_empty_equals_jax(entry, backend, shape):
    img = np.zeros(shape, np.uint8)
    kw = {} if backend is None else {"backend": backend}
    want = _run(lambda: getattr(jax_canny, entry)(img, MN, MX,
                                                  kernel_vals=K14, **kw))
    got = _run(lambda: getattr(port_canny, entry)(img, MN, MX,
                                                  kernel_vals=K14,
                                                  device="cpu", **kw))
    if isinstance(want, Exception):
        assert isinstance(got, ValueError), (want, got)
        return
    assert not isinstance(got, Exception), got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_empty_model_equals_cannytpu(backend):
    """The model classes, which call the entry points: a frame of no rows,
    its packed words and a batch of such frames."""
    img, imgs = np.zeros((0, 40), np.uint8), np.zeros((2, 0, 40), np.uint8)
    jax_model = CannyTPU(1.4, backend=backend)
    model = CannyTorch(1.4, backend=backend, device="cpu")
    for call in ("__call__", "packed"):
        want = np.asarray(getattr(jax_model, call)(img, MN, MX))
        got = getattr(model, call)(img, MN, MX).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
    want = np.asarray(jax_model.batch(imgs, MN, MX))
    got = model.batch(imgs, MN, MX).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape


def test_empty_runs_no_stage(monkeypatch):
    """An empty result is made where it is asked for: no front end (kernel
    or plain) and no flood runs."""
    def fail(*a, **k):
        raise AssertionError("a stage ran on an empty frame")

    for name in ("frontend", "frontend_nm", "hysteresis_packed",
                 "hysteresis_packed_plain", "canny_fused"):
        monkeypatch.setattr(port_canny, name, fail)
    before = kfe.launches
    for backend in ("xla", "fused"):
        out = port_canny.canny_fn(torch.zeros((0, 40), dtype=torch.uint8),
                                  MN, MX, kernel_vals=K14, backend=backend)
        assert out.shape == (0, 40) and out.dtype == torch.int16
    out = port_canny.canny_fn_packed(torch.zeros((3, 0, 65),
                                                 dtype=torch.uint8),
                                     MN, MX, kernel_vals=K14)
    assert out.shape == (3, 0, 3) and out.dtype == torch.uint32
    assert kfe.launches == before


def _frame_of(dtype):
    """A 40x70 frame of ``dtype`` from the headline frame, and thresholds
    that mark edges on it: full range for uint16, + 0.5 for float32, the
    upper half for bool (magnitudes 0 to 4)."""
    base = make_image(40, 70, seed=0)
    if dtype == "uint16":
        return (base.astype(np.uint16) * 257).astype(np.uint16), MN, MX
    if dtype == "float32":
        return base.astype(np.float32) + np.float32(0.5), MN, MX
    return base >= 128, 1, 2


@pytest.mark.parametrize("dtype", ["uint16", "float32", "bool"])
@pytest.mark.parametrize("backend", ["xla", "fused", "pallas"])
def test_other_dtypes_pinned(dtype, backend):
    """Past the uint8 contract: the port's ``xla`` equals JAX's ``xla``
    (JAX's own ``pallas`` differs from it there, so no single JAX answer
    exists); the port's ``fused`` takes a uint16 frame and equals its
    ``xla`` there, and refuses the others, as ``pallas`` refuses all three.
    The uint16 frame's gradients pass int32's range: the plain front end
    squares them in int64 (JAX's in float32, exact on this frame)."""
    img, mn, mx = _frame_of(dtype)

    def port(backend=backend):
        return port_canny.canny_fn(torch.from_numpy(img), mn, mx,
                                   kernel_vals=K14, backend=backend)

    if (dtype, backend) == ("uint16", "fused"):
        want = port("xla").numpy()
        assert (want == 255).any()
        np.testing.assert_array_equal(port().numpy(), want)
        return
    if backend != "xla":
        with pytest.raises(ValueError, match="expected a non-empty uint8"):
            port()
        return
    want = np.asarray(jax_canny.canny_fn(img, mn, mx, kernel_vals=K14,
                                         backend="xla"))
    got = port().numpy()
    assert (want == 255).any()
    np.testing.assert_array_equal(got, want)


def test_jax_cpu_products_drop_the_sign():
    """The cause of the signed-blur divergence: JAX's product helper on the
    CPU returns |x w| where x w < 0; the port's eager product is IEEE's.
    JAX's division helper agrees with IEEE on signed accumulators."""
    xs = np.array([-128, -77.5, -1, 0, 1, 77.5, 255, 300], np.float32)
    for w in (np.float32(K14[5]), np.float32(-0.25)):
        ieee = (xs * w).astype(np.float32)
        jax_prod = np.asarray(jax_numerics.mul_const_f32(jnp.asarray(xs),
                                                         float(w)))
        port_prod = (torch.from_numpy(xs) * float(w)).numpy()
        np.testing.assert_array_equal(port_prod, ieee)
        np.testing.assert_array_equal(jax_prod, np.abs(ieee))
    accs = np.array([-300.5, -128, -1.25, 0, 1.25, 255.9, 1e4], np.float32)
    for cnt in (np.float32(0.7), np.float32(K14.sum(dtype=np.float32))):
        got = np.asarray(jax_numerics.exact_div_by_vector(
            jnp.asarray(accs), jnp.float32(cnt),
            recip=jnp.float32(np.float32(1) / cnt)))
        np.testing.assert_array_equal(got, (accs / cnt).astype(np.float32))


# (name, frame, taps) -> (pixels of the edge map, first differing pixel;
# pixels of the NMS map, first differing pixel) against JAX's xla on the CPU
SIGNED_BLUR = {
    "int32 frame - 128": ((39, (8, 44)), (181, (0, 5))),
    "taps (-0.25, 1.5, -0.25)": ((686, (0, 0)), (1232, (0, 0))),
}


def _signed_case(name):
    base = make_image(40, 70, seed=0)
    if name.startswith("int32"):
        return base.astype(np.int32) - 128, K14
    return base, np.array([-0.25, 1.5, -0.25], np.float32)


def _first_diff(a, b):
    d = np.argwhere(a != b)
    return int((a != b).sum()), tuple(int(v) for v in d[0])


@pytest.mark.parametrize("name", sorted(SIGNED_BLUR))
def test_blur_outside_0_255_divergence(name):
    """A blur outside [0, 255]: the port's plain pipeline (IEEE products)
    against JAX's ``xla`` on the CPU (products without their sign), edge
    map and NMS map, as recorded; the port's backends agree with each other
    where they take the frame."""
    img, taps = _signed_case(name)
    want = np.asarray(jax_canny.canny_fn(img, MN, MX, kernel_vals=taps,
                                         backend="xla"))
    got = port_canny.canny_fn(torch.from_numpy(img), MN, MX,
                              kernel_vals=taps, backend="xla").numpy()
    jnm = np.asarray(jax_window.frontend_nm_xla(jnp.asarray(img), taps))
    pnm = port_window.frontend_nm(torch.from_numpy(img), taps).numpy()
    assert (_first_diff(got, want), _first_diff(pnm, jnm)) == \
        SIGNED_BLUR[name]
    if img.dtype == np.uint8:
        for backend in ("fused", "pallas"):
            other = port_canny.canny_fn(torch.from_numpy(img), MN, MX,
                                        kernel_vals=taps, backend=backend)
            np.testing.assert_array_equal(other.numpy(), got)


def test_uint16_nms_map_equals_jax():
    """The repair for frames past uint8: the plain front end squares its
    gradients in int64, so a full-range uint16 frame (gradients past
    46340) gives JAX's NMS map, not a wrapped int32 magnitude."""
    img, _, _ = _frame_of("uint16")
    want = np.asarray(jax_window.frontend_nm_xla(jnp.asarray(img), K14))
    got = port_window.frontend_nm(torch.from_numpy(img), K14)
    assert got.dtype == torch.int32 and want.max() == 50114 > 46340
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_isqrt_exact_over_int32(dtype):
    """``isqrt`` is floor(sqrt(n)) in ``n``'s dtype over the whole int32
    range: at each square, one below it, and past 46340^2, where an int32
    product (k + 1)^2 would wrap."""
    k = np.array([0, 1, 2, 1448, 46339, 46340], dtype=np.int64)
    n = np.unique(np.concatenate([k * k, k * k - 1, k * k + 1,
                                  [46340 ** 2 + 46340, 2 ** 31 - 2,
                                   2 ** 31 - 1]]))
    n = n[n >= 0]
    got = port_window.isqrt(torch.from_numpy(n).to(dtype))
    want = np.array([int(np.floor(np.sqrt(float(v)))) for v in n])
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_window.isqrt(torch.tensor([2 ** 31 - 1], dtype=dtype)) == 46340
