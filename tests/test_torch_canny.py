"""PyTorch port, whole slice: ``CannyTorch(device="cpu")`` against
``CannyTPU(backend="fused")`` bit for bit (int16 edges and packed uint32
edges, component and strict mode, the test image and the fuzz shapes), the
model's validation, its device policy, and the package's independence from
JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu.io.imageio import synthetic_image

MODES = ["component", "strict-reference"]


def _fuzz_configs():
    """The seeded configurations of tests/test_fuzz_bitexact.py, H <= 700
    (the same generator; the two tall band-boundary cases are left out)."""
    rng = np.random.default_rng(20260817)
    cfgs = []
    for i in range(8):
        h = int(rng.integers(16, 700))
        w = int(rng.integers(16, 700))
        sigma = float(rng.choice([0.5, 0.75, 1.0, 1.4, 2.0, 2.5, 3.0]))
        mn = int(rng.integers(0, 80))
        mx = mn + int(rng.integers(1, 120))
        cfgs.append((i, h, w, sigma, mn, mx))
    return cfgs


FUZZ = _fuzz_configs()


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _tpu(sigma, mode):
    from canny_edge_tpu.models import CannyTPU

    return CannyTPU(sigma=sigma, backend="fused", hysteresis_mode=mode)


@pytest.mark.parametrize("mode", MODES)
def test_call_and_packed_vs_cannytpu(mode, test_image):
    ref = _tpu(1.0, mode)
    model = CannyTorch(1.0, hysteresis_mode=mode, device="cpu")
    out = model(test_image, 50, 150)
    assert out.dtype == torch.int16 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref(test_image, 50, 150)))
    bits = model.packed(test_image, 50, 150)
    assert bits.dtype == torch.uint32
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(ref.packed(test_image, 50, 150)))


@pytest.mark.parametrize("mode", MODES)
def test_batch_vs_cannytpu(mode):
    frames = np.stack([synthetic_image(72, 100, seed=s) for s in range(3)])
    ref = _tpu(1.4, mode)
    model = CannyTorch(1.4, hysteresis_mode=mode, device="cpu")
    np.testing.assert_array_equal(model.batch(frames, 30, 90).numpy(),
                                  np.asarray(ref.batch(frames, 30, 90)))
    np.testing.assert_array_equal(model.batch_packed(frames, 30, 90).numpy(),
                                  np.asarray(ref.batch_packed(frames, 30, 90)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("i,h,w,sigma,mn,mx", FUZZ)
def test_fuzz_vs_cannytpu(i, h, w, sigma, mn, mx, mode):
    img = np.random.default_rng(1000 + i).integers(0, 256, (h, w), np.uint8)
    out = CannyTorch(sigma, hysteresis_mode=mode, device="cpu")(img, mn, mx)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(_tpu(sigma, mode)(img, mn, mx)))


@pytest.mark.parametrize("shape", [(1, 50), (50, 1), (1, 1), (2, 2), (3, 200),
                                   (200, 3)])
def test_degenerate_shapes_vs_cannytpu(shape):
    img = np.random.default_rng(17).integers(0, 256, shape, np.uint8)
    for mode in MODES:
        out = CannyTorch(1.0, hysteresis_mode=mode, device="cpu").packed(
            img, 50, 150)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(_tpu(1.0, mode).packed(img, 50, 150)))


@pytest.mark.parametrize("sigma", [0.5, 2.0])
def test_from_numpy_params(sigma, test_image):
    ref = _tpu(sigma, "component")
    model = CannyTorch.from_numpy_params(ref.kernel, device="cpu")
    assert model.window == ref.window
    np.testing.assert_array_equal(model(test_image, 30, 90).numpy(),
                                  np.asarray(ref(test_image, 30, 90)))


def test_strict_corner_image_vs_cannytpu():
    """A bright pixel at (1, 0), beside the strict mode's excluded edge."""
    img = np.zeros((16, 64), np.uint8)
    img[1, 0] = 255
    for mode in MODES:
        out = CannyTorch(1.0, hysteresis_mode=mode, device="cpu")(img, 5, 60)
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(_tpu(1.0, mode)(img, 5, 60)))


@pytest.mark.parametrize("args,exc", [
    ((np.zeros((4, 4), np.uint8), 150, 50), ValueError),
    ((np.zeros((4, 4), np.uint8), 50, 50), ValueError),
    ((np.zeros((4, 4), np.uint8), -1, 50), ValueError),
    ((np.zeros((4, 4), np.uint8), 10, 256), ValueError),
    ((np.zeros((4, 4), np.float32), 10, 20), TypeError),
    ((torch.zeros((4, 4), dtype=torch.int16), 10, 20), TypeError),
    ((np.zeros((4, 4), np.uint16), 1176, 3529), ValueError),
    ((np.zeros((4, 4), np.uint16), 50, 50), ValueError),
])
def test_validate_same_errors(args, exc):
    from canny_edge_tpu.models import CannyTPU

    img, mn, mx = args
    with pytest.raises(exc) as ours:
        CannyTorch._validate(img, mn, mx)
    with pytest.raises(exc) as theirs:
        CannyTPU._validate(img if isinstance(img, np.ndarray) else img.numpy(),
                           mn, mx)
    assert str(ours.value) == str(theirs.value)


def test_validate_uint16_on_purpose():
    """A divergence on purpose: with ``wide`` (``fused`` or ``xla`` in
    component mode) the port takes a uint16 frame and thresholds up to
    65535, where ``CannyTPU`` refuses it; without, it refuses it as
    ``CannyTPU`` does, in its order, and its ``TypeError`` goes on to name
    the backend that takes it.  A uint8 frame keeps [0, 255] either way."""
    from canny_edge_tpu.models import CannyTPU

    img = np.zeros((4, 4), np.uint16)
    for mn, mx in ((1176, 3529), (0, 65535)):
        CannyTorch._validate(img, mn, mx, wide=True)
        with pytest.raises((TypeError, ValueError)):
            CannyTPU._validate(img, mn, mx)
    with pytest.raises(ValueError, match=r"range of \[0,65535\]"):
        CannyTorch._validate(img, 10, 65536, wide=True)
    with pytest.raises(TypeError) as theirs:
        CannyTPU._validate(img, 10, 20)
    with pytest.raises(TypeError, match="taken by backend 'fused'") as ours:
        CannyTorch._validate(img, 10, 20)
    assert str(ours.value).startswith(str(theirs.value))
    with pytest.raises(ValueError, match=r"range of \[0,255\]"):
        CannyTorch._validate(np.zeros((4, 4), np.uint8), 10, 256, wide=True)


def test_bad_mode_and_batch_shape():
    with pytest.raises(ValueError, match="unknown hysteresis mode"):
        CannyTorch(1.0, hysteresis_mode="bfs", device="cpu")
    with pytest.raises(ValueError):
        CannyTorch(1.0, device="cpu").batch(np.zeros((4, 4), np.uint8), 1, 2)


@pytest.mark.parametrize("method", ["batch", "batch_packed"])
def test_batch_shape_message_vs_cannytpu(method):
    """A batch method refuses a frame with ``CannyTPU``'s message, as a
    ``ValueError`` where JAX asserts (ROADMAP, "Divergences on purpose")."""
    frame = synthetic_image(24, 40, seed=0)
    with pytest.raises(AssertionError) as theirs:
        getattr(_tpu(1.0, "component"), method)(frame, 30, 90)
    with pytest.raises(ValueError) as ours:
        getattr(CannyTorch(1.0, device="cpu"), method)(frame, 30, 90)
    assert str(ours.value) == str(theirs.value) == \
        f"{method} expects (B, H, W)"


REQUESTS = ["__call__", "packed", "batch", "batch_packed", "canny_fn",
            "canny_fn_batch", "canny_fn_packed"]


@pytest.mark.parametrize("kind", REQUESTS)
def test_a_request_asks_for_its_launch_plan_once(kind, monkeypatch):
    """Every ``fused`` request asks :func:`kernels.plan.run` once, whether
    a plan takes it or (as on the CPU) K1's and K2's wrappers do."""
    from canny_edge_tpu_torch.kernels import plan
    from canny_edge_tpu_torch.models.canny import canny_fn, canny_fn_packed

    calls, run = [], plan.run

    def counting(img, taps, bounds, strict, packed):
        calls.append(packed)
        return run(img, taps, bounds, strict, packed)

    monkeypatch.setattr(plan, "run", counting)
    frames = np.stack([synthetic_image(24, 40, seed=s) for s in range(2)])
    model = CannyTorch(1.0, device="cpu")
    if kind.startswith("canny_fn"):
        fn = canny_fn_packed if kind == "canny_fn_packed" else canny_fn
        extra = {} if kind == "canny_fn_packed" else {"backend": "fused"}
        fn(frames if kind != "canny_fn" else frames[0], 30, 90,
           kernel_vals=model.taps, device="cpu", **extra)
    else:
        getattr(model, kind)(frames if "batch" in kind else frames[0], 30, 90)
    assert calls == ["packed" in kind]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CannyTorch(1.0)
    with pytest.raises(RuntimeError):
        CannyTorch.from_numpy_params(np.ones(3, np.float32) / 3)


def test_import_loads_no_jax():
    """Importing the port adds neither JAX nor the JAX package to
    sys.modules (counting only what the import itself loads)."""
    code = ("import sys; before = set(sys.modules); "
            "import canny_edge_tpu_torch, canny_edge_tpu_torch.kernels."
            "frontend, canny_edge_tpu_torch.kernels.hysteresis_packed, "
            "canny_edge_tpu_torch.kernels.hysteresis, "
            "canny_edge_tpu_torch.kernels.hysteresis_v2, "
            "canny_edge_tpu_torch.kernels.fused, canny_edge_tpu_torch.ops."
            "dilate, canny_edge_tpu_torch.ops.banded, "
            "canny_edge_tpu_torch.ops.packed_tiles, canny_edge_tpu_torch.cli, "
            "canny_edge_tpu_torch.config, canny_edge_tpu_torch.io, "
            "canny_edge_tpu_torch.io.imageio, canny_edge_tpu_torch.io.video, "
            "canny_edge_tpu_torch.runtime, "
            "canny_edge_tpu_torch.parallel.streaming, "
            "canny_edge_tpu_torch.utils.timing, "
            "canny_edge_tpu_torch.utils.trace, "
            "canny_edge_tpu_torch.ops.stages, "
            "canny_edge_tpu_torch.models.sobel; "
            "bad = [m for m in set(sys.modules) - before if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'canny_edge_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_card_vs_cpu(cuda_device, mode, test_image):
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp

    frames = np.stack([synthetic_image(300, 500, seed=s) for s in range(2)])
    card = CannyTorch(1.4, hysteresis_mode=mode)
    cpu = CannyTorch(1.4, hysteresis_mode=mode, device="cpu")
    before = (kfe.launches, khp.launches)
    assert torch.equal(card(test_image, 30, 90).cpu(), cpu(test_image, 30, 90))
    assert torch.equal(card.batch_packed(frames, 30, 90).cpu().view(torch.int32),
                       cpu.batch_packed(frames, 30, 90).view(torch.int32))
    # one launch of each kernel for the frame, one for the batch
    assert kfe.launches == before[0] + 2 and khp.launches == before[1] + 2


def test_sources_import_no_jax():
    """No module of the port, nor chip_smoke.py, names JAX or the JAX
    package in an import statement."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "canny_edge_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "canny_edge_tpu"), f"{path}: {name}"
