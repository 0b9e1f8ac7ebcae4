"""PyTorch port: the three repairs of the port's faults.

* K1 takes any odd window: ``CannyTorch`` at sigma 6.0 (window 37) and 9.0
  (window 55) on the ``fused``, ``pallas`` and ``xla`` backends and
  ``packed`` bit-equal to JAX's ``CannyTPU`` on the CPU (the card tests hold
  the card against the CPU);
* ``--backend golden`` runs without ``--device`` on a host with no card;
* every name that ``canny_edge_tpu.{ops,kernels,utils,parallel,models,
  golden}`` exports has its counterpart in the port's subpackage of the
  same name.
"""

import ast
import contextlib
import importlib
import io
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu.io.imageio import synthetic_image
from canny_edge_tpu_torch import CannyTorch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMAS = [6.0, 9.0]
_JAX = {}          # JAX's results by sigma: each compiles once


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _frame():
    return synthetic_image(64, 96, seed=1)


def _jax(sigma, what):
    from canny_edge_tpu.models import CannyTPU

    key = (sigma, what)
    if key not in _JAX:
        model = CannyTPU(sigma=sigma)
        fn = model.packed if what == "packed" else model
        _JAX[key] = np.asarray(fn(_frame(), 20, 60))
    return _JAX[key]


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
def test_large_sigma_equals_cannytpu(sigma, backend):
    model = CannyTorch(sigma, backend=backend, device="cpu")
    assert model.window in (37, 55)
    np.testing.assert_array_equal(model(_frame(), 20, 60).numpy(),
                                  _jax(sigma, "call"))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_large_sigma_packed_equals_cannytpu(sigma):
    got = CannyTorch(sigma, device="cpu").packed(_frame(), 20, 60)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  _jax(sigma, "packed").view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_card_large_sigma_equals_cpu(cuda_device, sigma, backend):
    img = synthetic_image(1080, 1920, seed=2)
    card = CannyTorch(sigma, backend=backend)
    cpu = CannyTorch(sigma, backend=backend, device="cpu")
    assert torch.equal(card(img, 20, 60).cpu(), cpu(img, 20, 60))
    assert torch.equal(card.packed(img, 20, 60).cpu().view(torch.int32),
                       cpu.packed(img, 20, 60).view(torch.int32))


def test_golden_backend_needs_no_card(tmp_path, monkeypatch):
    """``--backend golden`` without ``--device`` exits 0 with no card."""
    from canny_edge_tpu import golden
    from canny_edge_tpu_torch import cli
    from canny_edge_tpu_torch.io.imageio import load_grayscale, synthetic_image as synth

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["synthetic:64x96x2", "1.4", "30", "90", "--backend",
                       "golden", "--out-dir", str(tmp_path)])
    assert rc == 0
    got = load_grayscale(os.path.join(tmp_path, "edges_000001.png"))
    np.testing.assert_array_equal(
        got, golden.canny(synth(64, 96, seed=1), 1.4, 30, 90).astype(np.uint8))


def _jax_exports(sub):
    """The names ``canny_edge_tpu/<sub>/__init__.py`` imports."""
    tree = ast.parse(open(os.path.join(ROOT, "canny_edge_tpu", sub,
                                       "__init__.py")).read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


# JAX's name -> the port's object it stands for, where the two differ; a
# name the port does not have (a class named for its framework) is looked up
# under the counterpart's own name
COUNTERPARTS = {
    "ops": {"sobel": "ops.stages.sobel", "xy_gradient": "ops.window.sobel",
            "isqrt_int32": "ops.window.isqrt",
            "quantize_angle_int": "ops.stages.quantize_angle"},
    "kernels": {"frontend_nm": "kernels.frontend.frontend_nm",
                "hysteresis_pallas": "kernels.hysteresis.hysteresis_dilate",
                "hysteresis_packed_pallas":
                    "kernels.hysteresis_packed.hysteresis_packed_nm"},
    "utils": {"profile_stages": "utils.timing.profile_stages"},
    "parallel": {"ShardedCanny": "parallel.sharded.ShardedCanny",
                 "halo_exchange_2d": "parallel.halo.halo_exchange_2d"},
    "models": {"CannyTPU": "models.canny.CannyTorch",
               "SobelTPU": "models.sobel.SobelTorch"},
    "golden": {},
}


def _resolve(path):
    mod, _, name = f"canny_edge_tpu_torch.{path}".rpartition(".")
    return getattr(importlib.import_module(mod), name)


@pytest.mark.parametrize("sub", ["ops", "kernels", "utils", "parallel",
                                 "models", "golden"])
def test_every_jax_export_has_its_counterpart(sub):
    port = importlib.import_module(f"canny_edge_tpu_torch.{sub}")
    names = _jax_exports(sub)
    assert names
    for name in names:
        path = COUNTERPARTS[sub].get(name)
        own = (name if path is None or hasattr(port, name)
               else path.rpartition(".")[2])
        assert hasattr(port, own), f"{sub}.{name}"
        if path is not None:
            assert getattr(port, own) is _resolve(path)
    if sub == "ops":
        from canny_edge_tpu_torch.ops import sobel  # noqa: F401
