"""PyTorch port: thresholds read as the JAX package reads them.

JAX reads a threshold in one of two ways, and the port follows each:

* the model classes (``CannyTPU``, ``SobelTPU``, ``ShardedCanny``) call
  ``jnp.int32(t)`` first, which truncates a float (30.5 means 30);
* everything else compares ``x >= t`` under JAX's promotion, which for a
  float compares in float32 (30.5 means 31, ``30 + 1e-8`` means 30, NaN
  and +inf mark no pixel, -inf every pixel).

Each entry point of the port runs against its JAX counterpart on the same
NumPy frames (a 96x130 diagonal ramp XOR noise/4, sigma 1.4; a batch of
three) with the thresholds 30.5/90.5, ``np.float32``, 0-d tensors (JAX gets
the 0-d array) and ``mn + 1e-8``, and on the functional entry points also
NaN, +inf and -inf.  JAX's Pallas kernels run in interpret mode.  JAX's
``packed``, ``batch_packed`` and ``with_intermediates`` are one function
whatever the backend, so one JAX model gives their reference for the
port's three backends.  Then the host rule itself
(:mod:`canny_edge_tpu_torch.ops.thresholds`) against a brute force, the
sigma-0.1 frame against ``golden``, a negative sigma, and on the card each
kernel against its plain version.

Tolerance: none (bit-equal, equal dtypes).
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu.golden.reference import gaussian_kernel
from canny_edge_tpu_torch import CannyTorch, SobelTorch
from canny_edge_tpu_torch import golden as port_golden
from canny_edge_tpu_torch import models
from canny_edge_tpu_torch.kernels.frontend import frontend
from canny_edge_tpu_torch.kernels.hysteresis import hysteresis_dilate
from canny_edge_tpu_torch.kernels.hysteresis_packed import hysteresis_packed_nm
from canny_edge_tpu_torch.kernels.hysteresis_v2 import hysteresis_banded
from canny_edge_tpu_torch.ops.thresholds import (INT32_MAX, INT32_MIN,
                                                 at_least, threshold_bound,
                                                 threshold_int32)
from canny_edge_tpu_torch.parallel import ShardedCanny, make_mesh

SIGMA = 1.4
KV = tuple(float(v) for v in gaussian_kernel(SIGMA))
BACKENDS = ["xla", "fused", "pallas"]
NAN, INF = float("nan"), float("inf")


def _frame(seed, h=96, w=130):
    """A diagonal ramp XOR noise/4: long edges with ties and fragments."""
    y, x = np.mgrid[:h, :w]
    ramp = ((y + x) * 255 // (h + w - 2)).astype(np.uint8)
    noise = np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)
    return ramp ^ (noise // 4)


# seeds where 30 and 31 (FRAME, 7) or 90 and 91 (2) give different edges
FRAME = _frame(7)
BATCH = np.stack([_frame(s) for s in (2, 5, 7)])

# threshold pairs a caller passes; the model classes truncate each to
# (30, 90), the other entry points compare 30.5 as 31 and 30 + 1e-8 as 30
CASES = {
    "half": (30.5, 90.5),
    "float32": (np.float32(30.5), np.float32(90.5)),
    "tensor": (torch.tensor(30.5), torch.tensor(90.5)),
    "eps": (30 + 1e-8, 90 + 1e-8),
}
# and on the functional entry points
SPECIAL = {"nan": (NAN, 90.5), "inf": (30.5, INF), "-inf": (-INF, 90.5),
           "-inf-nan": (-INF, NAN)}


def _jax(t):
    """The JAX counterpart of a threshold: a 0-d tensor as its 0-d array."""
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _jax32(t):
    """The threshold as JAX's jitted functions get it here: a float as the
    float32 that JAX rounds a Python float to (one compile a function, not
    one a weak and one a strong type; ``test_jax_rounds_a_python_float``
    holds the two alike)."""
    t = _jax(t)
    return np.float32(t) if isinstance(t, float) else t


def _eq(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


@functools.lru_cache(maxsize=None)
def _jax_model(backend):
    from canny_edge_tpu.models import CannyTPU

    return CannyTPU(sigma=SIGMA, backend=backend)


@functools.lru_cache(maxsize=None)
def _port_model(backend):
    return CannyTorch(SIGMA, device="cpu", backend=backend)


@functools.lru_cache(maxsize=None)
def _jax_fn(name, backend):
    """JAX's functional entry point, jitted once (the thresholds traced)."""
    from canny_edge_tpu.models import canny

    kw = {"kernel_vals": KV}
    if name != "canny_fn_packed":
        kw["backend"] = backend
    return jax.jit(functools.partial(getattr(canny, name), **kw))


# ---------------------------------------------------------------------------
# the model classes: truncation, as jnp.int32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_model_call_and_batch_equal_cannytpu(backend, case):
    mn, mx = CASES[case]
    ref, port = _jax_model(backend), _port_model(backend)
    _eq(port(FRAME, mn, mx), ref(FRAME, _jax(mn), _jax(mx)))
    _eq(port.batch(BATCH, mn, mx), ref.batch(BATCH, _jax(mn), _jax(mx)))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_model_packed_and_intermediates_equal_cannytpu(backend, case):
    mn, mx = CASES[case]
    ref, port = _jax_model("fused"), _port_model(backend)
    _eq(port.packed(FRAME, mn, mx), ref.packed(FRAME, _jax(mn), _jax(mx)))
    _eq(port.batch_packed(BATCH, mn, mx),
        ref.batch_packed(BATCH, _jax(mn), _jax(mx)))
    _eq(port.with_intermediates(FRAME, mn, mx)[0],
        ref.with_intermediates(FRAME, _jax(mn), _jax(mx))[0])


def test_frames_tell_the_rules_apart():
    """Truncating 30.5/90.5 and comparing them in float32 give different
    edges on the frame and on each frame of the batch, by the low threshold
    and by the high one, so the cases above tell the two rules apart."""
    def edges(f, mn, mx):
        return golden.canny(f, SIGMA, mn, mx)

    for f in (FRAME, *BATCH):
        assert (edges(f, 30, 90) != edges(f, 30.5, 90.5)).any()
    assert (edges(FRAME, 30, 90) != edges(FRAME, 30.5, 90)).any()
    assert (edges(BATCH[0], 30, 90) != edges(BATCH[0], 30, 90.5)).any()


def test_model_messages_unchanged():
    port = _port_model("fused")
    for (mn, mx), msg in (((90.5, 30.5), "minVal must be less than maxVal"),
                          ((-0.5, 30), "minVal must be in the range"),
                          ((30, 255.5), "maxVal must be in the range"),
                          ((NAN, 90), "minVal must be in the range")):
        for call in (lambda: port(FRAME, mn, mx),
                     lambda: port.batch(BATCH, mn, mx),
                     lambda: port.with_intermediates(FRAME, mn, mx)):
            with pytest.raises(ValueError, match=msg):
                call()
    with pytest.raises(ValueError, match=r"threshold must be in \[0, 1443\]"):
        SobelTorch(SIGMA, device="cpu")(FRAME, 1443.5)


# ---------------------------------------------------------------------------
# the functional entry points: JAX's promotion
# ---------------------------------------------------------------------------

FN_CASES = {**CASES, **SPECIAL}


@pytest.mark.parametrize("case", list(FN_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_canny_fn_and_batched_equal_jax(backend, case):
    mn, mx = FN_CASES[case]
    _eq(models.canny_fn(FRAME, mn, mx, kernel_vals=KV, backend=backend,
                        device="cpu"),
        _jax_fn("canny_fn", backend)(FRAME, _jax32(mn), _jax32(mx)))
    _eq(models.canny_fn_batched(BATCH, mn, mx, kernel_vals=KV,
                                backend=backend, device="cpu"),
        _jax_fn("canny_fn_batched", backend)(BATCH, _jax32(mn), _jax32(mx)))


@pytest.mark.parametrize("case", list(FN_CASES))
def test_canny_fn_packed_equals_jax(case):
    mn, mx = FN_CASES[case]
    _eq(models.canny_fn_packed(FRAME, mn, mx, kernel_vals=KV, device="cpu"),
        _jax_fn("canny_fn_packed", None)(FRAME, _jax32(mn), _jax32(mx)))


def test_jax_rounds_a_python_float():
    """JAX reads a Python float as the float32 it rounds to: its function
    gives the same map for ``t`` and ``np.float32(t)``, and so does the
    port's."""
    fn = _jax_fn("canny_fn", "xla")
    for mn, mx in ((30 + 1e-8, 90.5), (30.5, 90 + 1e-8), (NAN, INF),
                   (-INF, 90.5)):
        ref = fn(FRAME, mn, mx)
        _eq(ref, fn(FRAME, np.float32(mn), np.float32(mx)))
        _eq(models.canny_fn(FRAME, mn, mx, kernel_vals=KV, device="cpu"), ref)


def test_intermediates_fn_equals_jax():
    """``canny_with_intermediates`` compares as JAX does: 30.5 is not 30."""
    from canny_edge_tpu.models.canny import canny_with_intermediates

    ref = jax.jit(functools.partial(canny_with_intermediates,
                                    kernel_vals=KV))
    for mn, mx in ((30.5, 90.5), (30 + 1e-8, 90.25), (NAN, 90.5)):
        _eq(models.canny_with_intermediates(torch.from_numpy(FRAME), mn, mx,
                                            kernel_vals=KV)[0],
            ref(FRAME, _jax32(mn), _jax32(mx))[0])


# ---------------------------------------------------------------------------
# Sobel and the sharded model
# ---------------------------------------------------------------------------

SOBEL_CASES = {"half": 80.5, "float32": np.float32(80.5),
               "tensor": torch.tensor(80.5), "eps": 80 + 1e-8}


def test_sobel_equals_jax():
    from canny_edge_tpu.models.sobel import SobelTPU, sobel_fn

    ref, port = SobelTPU(SIGMA), SobelTorch(SIGMA, device="cpu")
    fn = jax.jit(functools.partial(sobel_fn, kernel_vals=KV))
    for t in SOBEL_CASES.values():
        _eq(port(FRAME, t), ref(FRAME, _jax(t)))
        _eq(port.batch(BATCH, t), ref.batch(BATCH, _jax(t)))
    for t in [*SOBEL_CASES.values(), NAN, INF, -INF]:
        _eq(models.sobel_fn(FRAME, t, kernel_vals=KV, device="cpu"),
            fn(FRAME, _jax32(t)))


# a 96x130 image is too narrow for the static engine over four columns of
# blocks (an interior block's cone leaves the image): it runs on (1, 4, 2)
@pytest.mark.parametrize("engine,mesh", [("static", (1, 4, 2)),
                                         ("generic", (1, 2, 4))])
def test_sharded_equals_jax(engine, mesh):
    from canny_edge_tpu.parallel import ShardedCanny as JShardedCanny
    from canny_edge_tpu.parallel import make_mesh as jmake_mesh

    d, y, x = mesh
    port = ShardedCanny(make_mesh([torch.device("cpu")] * 8, data=d, y=y,
                                  x=x), SIGMA, FRAME.shape, frontend=engine)
    ref = JShardedCanny(jmake_mesh(data=d, y=y, x=x), SIGMA, FRAME.shape,
                        frontend=engine)
    assert port.engine == ref.engine == engine
    for mn, mx in CASES.values():
        _eq(port(BATCH, mn, mx), ref(BATCH, _jax(mn), _jax(mx)))


# ---------------------------------------------------------------------------
# the host rule
# ---------------------------------------------------------------------------

def _maps():
    """Every int16 value, and int32 values across +-2**24."""
    i16 = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    i32 = torch.cat([torch.arange(-300, 300, dtype=torch.int32),
                     torch.tensor([-(1 << 24) + 1, -(1 << 24) + 2,
                                   (1 << 24) - 2, (1 << 24) - 1, 0],
                                  dtype=torch.int32)])
    return {torch.int16: i16, torch.int32: i32}


BOUND_CASES = [30, 30.5, -30.5, 30.00000001, 29.999999, -0.0, 0.49, -0.49,
               True, False, np.int64(7), np.int16(-5), np.float32(30.5),
               np.float64(90.25), 32767.5, 32768, -32769,
               1e30, -1e30, (1 << 24) - 1.5, float((1 << 24) + 1), NAN, INF,
               -INF, 1 << 40, -(1 << 40), torch.tensor(30.5),
               torch.tensor(7), torch.tensor(True),
               torch.tensor(30.5, dtype=torch.float64)]


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("t", BOUND_CASES, ids=repr)
def test_threshold_bound_equals_promotion(t, dtype):
    """``n >= threshold_bound(t)`` is ``n >= t`` as JAX promotes: an
    integer compares as an integer, a float as float32."""
    n = _maps()[dtype]
    tv = t.item() if isinstance(t, torch.Tensor) else t
    if isinstance(tv, (bool, int, np.integer)):
        want = n.numpy().astype(np.int64) >= int(tv)
    else:
        want = n.numpy().astype(np.float32) >= np.float32(tv)
    k = threshold_bound(t, dtype)
    assert isinstance(k, int) and INT32_MIN <= k <= INT32_MAX
    np.testing.assert_array_equal(n.numpy().astype(np.int64) >= k, want)
    np.testing.assert_array_equal(at_least(n, t).numpy(), want)
    assert threshold_bound(k, dtype) == k


def test_threshold_bound_ends():
    assert threshold_bound(NAN, torch.int16) == 32768
    assert threshold_bound(INF, torch.int16) == 32768
    assert threshold_bound(-INF, torch.int16) == -32768
    assert threshold_bound(NAN) == threshold_bound(1 << 40) == INT32_MAX
    assert threshold_bound(-INF) == threshold_bound(-(1 << 40)) == INT32_MIN
    assert threshold_bound(30.00000001) == 30       # float32 30.0
    assert threshold_bound(30.000002) == 31         # float32 30.000002


@pytest.mark.parametrize("t", [30, 30.5, -30.5, 29.999, -0.0, 0.99, -0.99,
                               True, np.int64(7), np.uint32(3_000_000_000),
                               np.float32(30.5), np.float64(-2.5),
                               np.float16(2.5), 2147483647, -2147483648,
                               2.1e9, NAN, INF, -INF, 1 << 31, -(1 << 31) - 1,
                               2.5e9],
                         ids=repr)
def test_threshold_int32_equals_numpy(t):
    try:
        want = int(np.int32(t))
    except (ValueError, OverflowError) as e:
        with pytest.raises(type(e)):
            threshold_int32(t)
        return
    assert threshold_int32(t) == want
    if not isinstance(t, np.uint32):
        assert threshold_int32(torch.tensor(t)) == want


def test_threshold_int32_equals_jnp_int32():
    import jax.numpy as jnp

    for t in (30.5, -30.5, np.float32(90.5), True, np.int64(7), 2147483647):
        assert threshold_int32(t) == int(jnp.int32(t))
    for t in (NAN, INF, 1 << 31):
        with pytest.raises((ValueError, OverflowError)):
            jnp.int32(t)
        with pytest.raises((ValueError, OverflowError)):
            threshold_int32(t)


# ---------------------------------------------------------------------------
# sigma 0.1, and a negative sigma
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_sigma_tenth_equals_golden(backend):
    """At sigma 0.1 (taps 1.93e-22, 1.0, 1.93e-22) the port's backends give
    ``golden``'s map.  JAX's blur does not: it writes -32768 at 107 pixels
    of this frame (``canny_edge_tpu/ops/stages.py:gaussian_blur``), and
    every backend of ``CannyTPU`` differs from ``golden`` there by 338-480
    pixels; ROADMAP.md records it as a divergence of the JAX package."""
    want = golden.canny(FRAME, 0.1, 30, 90)
    _eq(port_golden.canny(FRAME, 0.1, 30, 90), want)
    model = CannyTorch(0.1, device="cpu", backend=backend)
    _eq(model(FRAME, 30, 90), want)
    _eq(models.canny_fn(FRAME, 30.5, 90.5, kernel_vals=model.kernel,
                        backend=backend, device="cpu"),
        golden.canny(FRAME, 0.1, 30.5, 90.5))


def test_negative_sigma_raises():
    """A sigma whose window is empty (sigma <= -1/3) raises; ``CannyTPU``
    runs the empty kernel that ``gaussian_kernel`` returns for it, with
    divide-by-zero warnings, and gives ``golden``'s map."""
    for sigma in (-1.0, -0.5):
        with pytest.raises(ValueError, match="odd number of taps"):
            CannyTorch(sigma, device="cpu")


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

CARD_PAIRS = [(30.5, 90.5), (np.float32(30.5), 90 + 1e-8), (NAN, 90.5),
              (30.5, INF), (-INF, 90.5), (-INF, NAN)]


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_kernels_equal_plain(cuda_device):
    """K1's threshold mode, K2's NMS-map entry, K3 and K4, each on int16
    and int32 maps, equal their plain versions on the CPU."""
    img = torch.from_numpy(BATCH)
    taps = torch.tensor(KV, dtype=torch.float32)
    nm = frontend(img, taps)
    for mn, mx in CARD_PAIRS:
        dm = torch.tensor(mn, device=cuda_device) if mn == 30.5 else mn
        for got, want in zip(frontend(img.to(cuda_device),
                                      taps.to(cuda_device), (dm, mx)),
                             frontend(img, taps, (mn, mx))):
            _eq(got.cpu(), want)
        for m in (nm, nm.to(torch.int32)):
            dev = m.to(cuda_device)
            for fn in (hysteresis_packed_nm, hysteresis_dilate,
                       hysteresis_banded):
                _eq(fn(dev, dm, mx).cpu(), fn(m, mn, mx))
            _eq(hysteresis_packed_nm(dev, dm, mx, packed_out=True).cpu(),
                hysteresis_packed_nm(m, mn, mx, packed_out=True))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_card_models_equal_cpu_truncated(cuda_device, backend):
    card = CannyTorch(SIGMA, device=cuda_device, backend=backend)
    cpu = _port_model(backend)
    for mn, mx in CASES.values():
        _eq(card(FRAME, mn, mx).cpu(), cpu(FRAME, 30, 90))
        _eq(card.batch(BATCH, mn, mx).cpu(), cpu.batch(BATCH, 30, 90))
        _eq(card.packed(FRAME, mn, mx).cpu(), cpu.packed(FRAME, 30, 90))
        for fn, cmp in ((models.canny_fn, "canny_fn"),
                        (models.canny_fn_batched, "canny_fn_batched")):
            src = FRAME if cmp == "canny_fn" else BATCH
            for a, b in [(mn, mx), *SPECIAL.values()]:
                _eq(fn(src, a, b, kernel_vals=KV, backend=backend).cpu(),
                    fn(src, a, b, kernel_vals=KV, backend=backend,
                       device="cpu"))
