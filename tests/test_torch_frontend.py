"""PyTorch port, front end: Gaussian taps and the plain front end (K1's
plain version) against the JAX package, bit for bit (tolerance 0: every
operation is integer or correctly rounded float32).

Inputs are made from NumPy seeds and cross between the frameworks as NumPy
arrays; JAX runs on the CPU and the Pallas front end in interpret mode.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu.golden.reference import gaussian_kernel as golden_kernel
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.ops import gaussian, window
from canny_edge_tpu.io.imageio import synthetic_image


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


SIGMAS = [0.5, 0.75, 1.0, 1.4, 2.0, 2.5, 3.0]
DEGENERATE = [(1, 50), (50, 1), (1, 1), (2, 2), (3, 200), (200, 3)]


def _img(shape, test_image):
    if shape == (256, 256):
        return test_image
    if min(shape) >= 8:
        return synthetic_image(*shape)
    return np.random.default_rng(17).integers(0, 256, shape, np.uint8)


def _xla(img, sigma, thresholds=None):
    import jax

    from canny_edge_tpu.ops.window import frontend_nm_xla

    kv = tuple(float(v) for v in golden_kernel(sigma))
    out = jax.jit(lambda x: frontend_nm_xla(x, kv, thresholds=thresholds))(img)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_gaussian_kernel_bitwise(sigma):
    from canny_edge_tpu.ops.window import _kernel_sum

    k = gaussian.gaussian_kernel(sigma)
    ref = golden_kernel(sigma)
    assert k.dtype == np.float32
    np.testing.assert_array_equal(k.view(np.int32), ref.view(np.int32))
    assert gaussian.gaussian_window(sigma) == ref.shape[0]
    assert gaussian.kernel_sum(k) == _kernel_sum(ref)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("shape", [(256, 256), (100, 200)] + DEGENERATE)
def test_frontend_plain_vs_xla(sigma, shape, test_image):
    img = _img(shape, test_image)
    k = gaussian.gaussian_kernel(sigma)
    nm = window.frontend_nm(torch.from_numpy(img), k)
    assert nm.dtype == torch.int32
    np.testing.assert_array_equal(nm.numpy(), _xla(img, sigma))


@pytest.mark.parametrize("thresholds", [(30, 90), (0, 40), (50, 150)])
@pytest.mark.parametrize("shape", [(256, 256), (100, 200), (1, 50), (50, 1),
                                   (3, 200)])
def test_frontend_plain_packed_vs_xla(thresholds, shape, test_image):
    img = _img(shape, test_image)
    weak, strong = window.frontend_nm(torch.from_numpy(img),
                                      gaussian.gaussian_kernel(1.4),
                                      thresholds)
    ref_w, ref_s = _xla(img, 1.4, thresholds)
    assert weak.dtype == torch.uint32
    np.testing.assert_array_equal(weak.numpy(), ref_w)
    np.testing.assert_array_equal(strong.numpy(), ref_s)


@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(256, 256), (100, 200)])
def test_frontend_plain_vs_pallas(sigma, shape, test_image):
    import jax

    from canny_edge_tpu.kernels import frontend_nm

    img = _img(shape, test_image)
    kv = tuple(float(v) for v in golden_kernel(sigma))
    ref = np.asarray(jax.jit(
        lambda x: frontend_nm(x, kv, tile=(64, 128)))(img))
    nm = window.frontend_nm(torch.from_numpy(img), gaussian.gaussian_kernel(sigma))
    np.testing.assert_array_equal(nm.numpy(), ref.astype(np.int32))


def test_frontend_wrapper_cpu_uses_plain(test_image):
    k = gaussian.gaussian_kernel(1.0)
    taps = torch.from_numpy(k)
    before = kfe.launches
    nm = kfe.frontend(torch.from_numpy(test_image), taps)
    assert nm.dtype == torch.int16
    np.testing.assert_array_equal(nm.numpy(), _xla(test_image, 1.0))
    weak, strong = kfe.frontend(torch.from_numpy(test_image), taps, (50, 150))
    ref_w, ref_s = _xla(test_image, 1.0, (50, 150))
    np.testing.assert_array_equal(weak.numpy(), ref_w)
    np.testing.assert_array_equal(strong.numpy(), ref_s)
    assert kfe.launches == before  # the CPU path launches no kernel


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.float32),
                                 np.zeros((2, 2, 4, 4), np.uint8),
                                 np.zeros((0, 4), np.uint8)])
def test_frontend_wrapper_rejects(bad):
    with pytest.raises(ValueError):
        kfe.frontend(torch.from_numpy(bad), torch.ones(3))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.5, 1.4, 3.0])
@pytest.mark.parametrize("shape", [(1080, 1920), (257, 333), (1, 50), (50, 1)])
def test_frontend_kernel_vs_plain(cuda_device, sigma, shape):
    rng = np.random.default_rng(shape[0])
    img = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda_device)
    k = gaussian.gaussian_kernel(sigma)
    taps = torch.from_numpy(k).to(cuda_device)
    ref = window.frontend_nm(img, k)
    assert torch.equal(kfe.frontend(img, taps).to(torch.int32), ref)
    weak, strong = kfe.frontend(img, taps, (30, 90))
    ref_w, ref_s = window.frontend_nm(img, k, (30, 90))
    assert torch.equal(weak.view(torch.int32), ref_w.view(torch.int32))
    assert torch.equal(strong.view(torch.int32), ref_s.view(torch.int32))
