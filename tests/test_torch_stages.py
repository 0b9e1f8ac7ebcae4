"""PyTorch port, the unpacked stage path: ``ops/stages.py``,
``CannyTorch.with_intermediates`` and ``SobelTorch`` against
``canny_edge_tpu.ops.stages``, ``CannyTPU.with_intermediates``, ``SobelTPU``
(JAX on the CPU) and the NumPy oracle ``golden``, bit for bit; and, on the
card, against the same calls on the CPU.
"""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu.io.imageio import synthetic_image
from canny_edge_tpu.ops import stages as J
from canny_edge_tpu_torch import CannyTorch, SobelTorch
from canny_edge_tpu_torch.ops import stages as S

MODES = ["component", "strict-reference"]
SHAPES = [(37, 53), (64, 128), (1, 1), (2, 2), (1, 40), (40, 1), (2, 3),
          (3, 2)]
SIGMAS = [0.5, 1.0, 1.4, 2.0]
PAIRS = [(50, 150), (0, 40), (30, 90)]


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# the JAX stages jitted, one compilation a shape (and a mode) for the file
_jax_front = jax.jit(lambda sm: (*J.xy_gradient(sm), *J.sobel(sm),
                                 J.nonmax_suppression(*J.sobel(sm))))
_jax_hyst = jax.jit(J.hysteresis_with_stats, static_argnums=(3, 4))


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _eq(ours, theirs):
    theirs = np.asarray(theirs)
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


def _golden_hyst(nm, mn, mx, mode):
    fn = golden.hysteresis_strict if mode == MODES[1] else golden.hysteresis
    return fn(np.asarray(nm), mn, mx)


@pytest.mark.parametrize("i,shape", list(enumerate(SHAPES)))
def test_stages_vs_jax_and_golden(i, shape):
    """Every stage at every shape, with a sigma and a threshold pair taken
    in turn, both hysteresis modes."""
    sigma, (mn, mx) = SIGMAS[i % 4], PAIRS[i % 3]
    img = _img(shape, 100 + i)
    sm = S.gaussian_blur(torch.from_numpy(img), sigma)
    sm_j = J.gaussian_blur(img, sigma)
    _eq(sm, sm_j)
    _eq(sm, golden.gaussian_blur(img, sigma))
    gx_j, gy_j, mag_j, ang_j, nm_j = _jax_front(sm_j)
    gx, gy = S.xy_gradient(sm)
    _eq(gx, gx_j)
    _eq(gy, gy_j)
    mag, ang = S.sobel(sm)
    _eq(mag, mag_j)
    _eq(ang, ang_j)
    g_mag, g_ang = golden.sobel(np.asarray(sm_j))
    np.testing.assert_array_equal(mag.numpy(), g_mag)
    np.testing.assert_array_equal(ang.numpy(), g_ang)
    nm = S.nonmax_suppression(mag, ang)
    _eq(nm, nm_j)
    np.testing.assert_array_equal(nm.numpy(),
                                  golden.nonmax_suppression(g_mag, g_ang))
    for mode in MODES:
        out, iters = S.hysteresis_with_stats(nm, mn, mx, mode=mode)
        out_j, iters_j = _jax_hyst(nm_j, mn, mx, 4, mode)
        _eq(out, out_j)
        assert iters == int(iters_j)
        _eq(S.hysteresis(nm, mn, mx, mode=mode), out_j)
        np.testing.assert_array_equal(out.numpy(),
                                      _golden_hyst(nm, mn, mx, mode))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_blur_every_sigma(sigma):
    """The blur at each sigma on a batch (JAX and the oracle) and on a wide
    and a tall frame (the oracle)."""
    batch = np.stack([_img((37, 53), s) for s in range(3)])
    ours = S.gaussian_blur(torch.from_numpy(batch), sigma)
    _eq(ours, J.gaussian_blur(batch, sigma))
    for f in range(3):
        np.testing.assert_array_equal(ours[f].numpy(),
                                      golden.gaussian_blur(batch[f], sigma))
    for shape in ((64, 128), (53, 37)):
        img = _img(shape, int(sigma * 10))
        np.testing.assert_array_equal(
            S.gaussian_blur(torch.from_numpy(img), sigma).numpy(),
            golden.gaussian_blur(img, sigma))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mn,mx", PAIRS)
def test_hysteresis_modes_and_thresholds(mode, mn, mx):
    img = synthetic_image(64, 128, seed=5)
    nm_j = _jax_front(J.gaussian_blur(img, 1.0))[-1]
    nm = torch.from_numpy(np.array(nm_j))
    out, iters = S.hysteresis_with_stats(nm, mn, mx, mode=mode)
    out_j, iters_j = _jax_hyst(nm_j, mn, mx, 4, mode)
    _eq(out, out_j)
    assert iters == int(iters_j)
    np.testing.assert_array_equal(out.numpy(), _golden_hyst(nm, mn, mx, mode))


def test_strict_corner_and_bad_mode():
    """A weak run reachable only through the promotion (1,0)->(0,1)."""
    nm = np.zeros((16, 64), np.int32)
    nm[1, 0], nm[0, 1:10] = 10, 3
    for mode in MODES:
        _eq(S.hysteresis(torch.from_numpy(nm), 2, 10, mode=mode),
            J.hysteresis(nm, 2, 10, mode=mode))
    with pytest.raises(ValueError, match="unknown hysteresis mode"):
        S.hysteresis(torch.from_numpy(nm), 2, 10, mode="bfs")


def test_quantize_angle_every_gradient():
    """Every gradient pair a uint8 image can give, |g| <= 1020."""
    g = np.arange(-1020, 1021, dtype=np.int32)
    gx, gy = (a.ravel() for a in np.meshgrid(g, g))
    ours = S.quantize_angle(torch.from_numpy(gx), torch.from_numpy(gy))
    _eq(ours, J.quantize_angle_int(gx, gy))
    assert int(ours[(gx == 0) & (gy == 5)][0]) == 90
    assert int(ours[(gx == 0) & (gy == 0)][0]) == 0


@pytest.mark.parametrize("steps", [1, 4, 8])
def test_frontier_iterations_vs_jax(steps, test_image):
    """``frontier_iterations`` counts the JAX ``while_loop``'s way."""
    from canny_edge_tpu.models import CannyTPU

    ref = CannyTPU(sigma=1.0, hysteresis_steps=steps)
    model = CannyTorch(1.0, device="cpu", hysteresis_steps=steps)
    out, inter = model.with_intermediates(test_image, 30, 90)
    out_j, inter_j = ref.with_intermediates(test_image, 30, 90)
    _eq(out, out_j)
    assert inter["frontier_iterations"] == int(inter_j["frontier_iterations"])
    assert inter["frontier_iterations"] % steps == 0


@pytest.mark.parametrize("shape,sigma,mn,mx", [
    ((256, 256), 1.0, 50, 150), ((37, 53), 2.0, 0, 40), ((1, 40), 0.5, 30, 90),
    ((3, 2), 1.4, 30, 90)])
def test_with_intermediates_key_by_key(shape, sigma, mn, mx, test_image):
    from canny_edge_tpu.models import CannyTPU

    img = test_image if shape == (256, 256) else _img(shape, 7)
    out, inter = CannyTorch(sigma, device="cpu").with_intermediates(img, mn,
                                                                    mx)
    out_j, inter_j = CannyTPU(sigma=sigma).with_intermediates(img, mn, mx)
    _eq(out, out_j)
    assert set(inter) == set(inter_j)
    for k in ("smoothed", "magnitude", "angle", "nonmax"):
        _eq(inter[k], inter_j[k])
    assert inter["frontier_iterations"] == int(inter_j["frontier_iterations"])
    out_g, inter_g = golden.canny(img, sigma, mn, mx, intermediates=True)
    np.testing.assert_array_equal(out.numpy(), out_g)
    for k in inter_g:
        np.testing.assert_array_equal(inter[k].numpy(), inter_g[k])


@pytest.mark.parametrize("entry", ["call", "batch", "magnitude"])
def test_sobel_model_vs_sobeltpu(entry):
    from canny_edge_tpu.models.sobel import SobelTPU

    ref = SobelTPU(sigma=1.0)
    model = SobelTorch(1.0, device="cpu")
    img = synthetic_image(48, 70, seed=2)
    if entry == "call":
        for t in (0, 80, 1443):
            _eq(model(img, t), ref(img, t))
    elif entry == "batch":
        frames = np.stack([synthetic_image(48, 70, seed=s) for s in range(3)])
        _eq(model.batch(frames, 80), ref.batch(frames, 80))
    else:
        _eq(model.magnitude(img), ref.magnitude(img))


@pytest.mark.parametrize("threshold", [-1, 1444])
def test_sobel_threshold_message(threshold):
    from canny_edge_tpu.models.sobel import SobelTPU

    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError) as ours:
        SobelTorch(1.0, device="cpu")(img, threshold)
    with pytest.raises(ValueError) as theirs:
        SobelTPU(1.0)(img, threshold)
    assert str(ours.value) == str(theirs.value)


def test_sobel_and_intermediates_validation(monkeypatch):
    model = SobelTorch(1.0, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        model(np.zeros((8, 8), np.float32), 10)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        model.batch(np.zeros((8, 8), np.uint8), 10)
    with pytest.raises(ValueError, match="less than"):
        CannyTorch(1.0, device="cpu").with_intermediates(
            np.zeros((8, 8), np.uint8), 90, 30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SobelTorch(1.0)


@pytest.mark.cuda
def test_stages_card_vs_cpu(cuda_device):
    img = synthetic_image(300, 500, seed=4)
    for mode in MODES:
        outs = []
        for dev in (cuda_device, "cpu"):
            sm = S.gaussian_blur(torch.from_numpy(img).to(dev), 1.4)
            mag, ang = S.sobel(sm)
            nm = S.nonmax_suppression(mag, ang)
            outs.append([t.cpu() for t in (sm, mag, ang, nm)]
                        + list(S.hysteresis_with_stats(nm, 30, 90, mode=mode)))
        for a, b in zip(*outs):
            assert torch.equal(a.cpu(), b) if isinstance(b, torch.Tensor) \
                else a == b


@pytest.mark.cuda
def test_intermediates_and_sobel_card_vs_cpu(cuda_device):
    from canny_edge_tpu_torch.kernels.frontend import frontend

    img = synthetic_image(270, 480, seed=6)
    card = CannyTorch(1.4)
    out, inter = card.with_intermediates(img, 30, 90)
    out_c, inter_c = CannyTorch(1.4, device="cpu").with_intermediates(img, 30,
                                                                      90)
    assert torch.equal(out.cpu(), out_c) and torch.equal(out, card(img, 30, 90))
    for k in ("smoothed", "magnitude", "angle", "nonmax"):
        assert torch.equal(inter[k].cpu(), inter_c[k]), k
    assert inter["frontier_iterations"] == inter_c["frontier_iterations"]
    assert torch.equal(inter["nonmax"], frontend(
        torch.from_numpy(img).to(cuda_device), card.taps))
    sob, sob_c = SobelTorch(1.4), SobelTorch(1.4, device="cpu")
    assert torch.equal(sob(img, 80).cpu(), sob_c(img, 80))
    assert torch.equal(sob.magnitude(img).cpu(), sob_c.magnitude(img))
