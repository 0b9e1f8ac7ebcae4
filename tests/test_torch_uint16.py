"""PyTorch port: uint16 frames on the ``fused`` path.

K1's uint16 instantiations (``canny_frontend`` and ``canny_frontend_large``
with an item size of 2, and ``canny_run_plan`` with a uint16 plan) run on the CPU under
``tools/cuda_emu`` and are held to both references of the benchmark, the
frozen NumPy oracle (``portbench/reference/oracle.py``) and the plain
PyTorch pipeline (``portbench/reference/plain_torch.py``): the tile path at
11 and 19 taps in frame and batch mode, the ring path at 121 taps and the
scratch path, at widths that are not a multiple of 32, at white levels of
10000 and 65535, and on step edges whose squared gradients pass 2^24 (a
float32 magnitude would fail) and 2^32.  ``CannyTorch(backend="fused")``
on CPU uint16 frames equals the oracle; a uint16 and a uint8 frame of one
shape take two launch plans, and ``u16_frames`` counts the uint16 frames a
plan's K1 reads.  The ``cuda``-marked tests hold the card's kernels to the
same references.  Tolerance: 0 differing values.
"""

import ctypes

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import plan as kplan
from canny_edge_tpu_torch.kernels._build import SIGNATURES
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
from canny_edge_tpu_torch.ops.packed import (cdiv, hysteresis_packed_masks,
                                             pack_mask, unpack_edges)
from portbench.reference import frames, oracle
from portbench.reference import plain_torch
from tools import entry_spans
from tools.cuda_emu import build

SCALES = (10000, 65535)
# the bytes a pixel that K1's C entries take for a uint16 frame
U16 = 2


@pytest.fixture(scope="module")
def k1(tmp_path_factory):
    """K1 built for the CPU, once for the module (~6 s)."""
    lib = build("frontend", tmp_path_factory.mktemp("cuda_emu16"))
    ctypes.c_int.in_dll(lib, "emu_sms").value = 4
    return lib


def _scene(b, h, w, full, seed):
    """``b`` uint16 frames of the benchmark's scene at white level
    ``full``, drawn from ``seed``."""
    params = frames.frame_params(b, h, w, seed)
    return frames.make_pool(params, h, w, seed, torch.device("cpu"), w,
                            "uint16", full)


def _step(h, w, full):
    """A diagonal step from 0 to ``full`` with a square of ``full`` in a
    dark corner: gradients near 4 ``full`` a pixel."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.where(xx + yy > (h + w) // 2, full, 0)
    img[2:9, 3:12] = full
    return torch.from_numpy(img.astype(np.uint16))


def _thresholds(full):
    """cam1080's 30/90 at the white level ``full`` (s2l1c's 1176/3529 at
    10000)."""
    return round(30 * full / 255), round(90 * full / 255)


def _oracle_masks(img, sigma, mn, mx):
    """The oracle's NMS map as K1's packed (weak, strong) masks, its edge
    map, and the largest gx^2 + gy^2 of the frame."""
    edges, mid = oracle.canny(img.numpy(), sigma, mn, mx, intermediates=True)
    gx, gy = oracle.xy_gradient(mid["smoothed"])
    top = int((gx.astype(np.int64) ** 2 + gy.astype(np.int64) ** 2).max())
    nm = torch.from_numpy(mid["nonmax"])
    return (pack_mask(nm >= mn), pack_mask(nm >= mx)), edges, top


def _run(lib, entry, imgs, window, mn, mx):
    """K1's ``entry`` on a uint16 ``(B, H, W)`` batch into packed masks."""
    b, h, w = imgs.shape
    taps = torch.from_numpy(gaussian_kernel((window // 2 - 0.5) / 3))
    assert len(taps) == window
    weak = torch.zeros((b, h, cdiv(w, 32)), dtype=torch.uint32)
    strong = torch.zeros_like(weak)
    out = (1, mn, mx, None, weak.data_ptr(), strong.data_ptr())
    if entry == "canny_frontend":
        err = lib.canny_frontend(imgs.data_ptr(), U16, b, h, w,
                                 taps.data_ptr(), window, *out, None)
    else:
        n = kfe.scratch_floats(b, h, w, window)
        scratch = torch.zeros(n, dtype=torch.float32)
        err = lib.canny_frontend_large(imgs.data_ptr(), U16, b, 0, h, w, 0, 0,
                                       h, w, taps.data_ptr(), window, *out,
                                       scratch.data_ptr(), n, None)
    assert err == 0
    return weak, strong, taps


def _check(weak, strong, imgs, sigma, mn, mx):
    """Each frame's masks are the oracle's, and the plain flood on them
    gives the oracle's and the plain PyTorch pipeline's edges."""
    for i, img in enumerate(imgs):
        (mw, ms), edges, _ = _oracle_masks(img, sigma, mn, mx)
        assert torch.equal(weak[i], mw) and torch.equal(strong[i], ms)
        got = hysteresis_packed_masks(weak[i], strong[i], *img.shape)[0]
        np.testing.assert_array_equal(
            unpack_edges(got, img.shape[1]).numpy(), edges)
        np.testing.assert_array_equal(
            plain_torch.canny(img, sigma, mn, mx).numpy(), edges)


# (window, batch, shape): the tile path at 11 (cam1080's and s2l1c's) and
# 19 taps, one frame and a batch of 3, widths that are not a multiple of
# 32 (nor, at 70, of 4: rows off 8-byte boundaries)
TILES = [(11, 1, (70, 100)), (11, 3, (37, 70)), (19, 1, (45, 102)),
         (19, 3, (40, 68))]


@pytest.mark.parametrize("full", SCALES)
@pytest.mark.parametrize("win,b,hw", TILES)
def test_emulated_tile_path_equals_both_references(k1, win, b, hw, full):
    imgs = _scene(b, *hw, full, seed=win + b)
    mn, mx = _thresholds(full)
    weak, strong, taps = _run(k1, "canny_frontend", imgs, win, mn, mx)
    sigma = (win // 2 - 0.5) / 3
    assert np.array_equal(taps.numpy(), oracle.gaussian_kernel(sigma))
    assert strong.any()
    _check(weak, strong, imgs, sigma, mn, mx)


def _float32_magnitude(gx, gy):
    """The magnitude as float32 arithmetic gives it (K1's uint8 rule,
    ``csrc/frontend.cu:mag_dir``, with a correctly rounded root): exact
    only while gx^2 + gy^2 stays below 2^24."""
    f = np.float32
    gx, gy = gx.astype(f), gy.astype(f)
    n = gx * gx + gy * gy
    k = (np.sqrt(n) + f(1 << 23)) - f(1 << 23)
    k = np.where(k * k > n, k - f(1), k)
    return np.where((k + f(1)) * (k + f(1)) <= n, k + f(1), k)


def _past_float32(kind, full):
    """A frame whose squared gradients pass 2^24, and thresholds: a step
    edge at the white level with cam1080's scaled, or full-range noise with
    the strong bound at a kept pixel whose float32 magnitude is wrong, so
    that a float32 magnitude marks that pixel otherwise."""
    if kind == "step":
        return _step(48, 76, full), _thresholds(full)
    rng = np.random.default_rng(0)
    img = rng.integers(0, full + 1, (48, 76)).astype(np.uint16)
    _, mid = oracle.canny(img, 1.5, 1, 2, intermediates=True)
    exact = mid["magnitude"].astype(np.int64)
    wrong = _float32_magnitude(*oracle.xy_gradient(mid["smoothed"]))
    miss = np.argwhere((mid["nonmax"] > 0) & (wrong != exact))
    assert len(miss), "no pixel where float32 arithmetic errs"
    y, x = miss[0]
    mx = int(exact[y, x]) + (wrong[y, x] > exact[y, x])
    return torch.from_numpy(img), (mx // 3, mx)


@pytest.mark.parametrize("kind,full", [("step", 10000), ("step", 65535),
                                       ("noise", 65535)])
def test_emulated_past_float32_squares(k1, kind, full):
    """Squared gradients past 2^24 (where a float32 magnitude is no longer
    exact; a step at 65535 also passes 2^32): the tile path at 11 taps
    still gives the oracle's masks and edges."""
    img, (mn, mx) = _past_float32(kind, full)
    top = _oracle_masks(img, 1.5, mn, mx)[2]
    assert top > 1 << 24
    if kind == "step" and full == 65535:
        assert top > 1 << 32
    weak, strong, _ = _run(k1, "canny_frontend", img[None], 11, mn, mx)
    assert strong.any()
    _check(weak, strong, img[None], 1.5, mn, mx)


def test_emulated_ring_and_scratch_paths(k1):
    """The ring path at 121 taps and the scratch path (any window, here
    121) on uint16 frames: the same masks as the oracle's."""
    imgs = torch.stack([_step(96, 100, 65535), _scene(1, 96, 100, 10000,
                                                      seed=3)[0]])
    sigma = (121 // 2 - 0.5) / 3
    for entry in ("canny_frontend", "canny_frontend_large"):
        weak, strong, _ = _run(k1, entry, imgs, 121, 4 * 257, 12 * 257)
        assert strong.any()
        for i, img in enumerate(imgs):
            (mw, ms), _, _ = _oracle_masks(img, sigma, 4 * 257, 12 * 257)
            assert torch.equal(weak[i], mw) and torch.equal(strong[i], ms)


def test_emulated_uint16_refuses_the_nms_map_and_the_ring_holds_less(k1):
    """A uint16 frame goes into the packed masks only (its magnitudes pass
    the int16 map), and its ring path holds a narrower window than the
    uint8 one's (twice the bytes of input and magnitudes)."""
    img = _step(40, 70, 255)
    taps = torch.from_numpy(gaussian_kernel(1.4))
    nm = torch.zeros((40, 70), dtype=torch.int16)
    assert k1.canny_frontend(img.data_ptr(), U16, 1, 40, 70, taps.data_ptr(),
                             11, 0, 0, 0, nm.data_ptr(), None, None,
                             None) != 0
    top8, top16 = k1.canny_frontend_max_window(1), \
        k1.canny_frontend_max_window(U16)
    assert 103 < top16 < top8
    assert k1.canny_frontend_smem_bytes(top16, U16) <= 232448 \
        < k1.canny_frontend_smem_bytes(top16 + 2, U16)
    # the tile path's uint16 block at 11 taps fits 4 an SM, as the uint8 one
    assert 4 * (k1.canny_frontend_smem_bytes(11, U16) + 1024) <= 233472


def test_emulated_plan_runs_a_uint16_request(k1):
    """``canny_run_plan`` from a uint16 plan: K1's uint16 instantiation
    fills the plan's masks, as the oracle's NMS map thresholds them."""
    b, h, w = 2, 37, 70
    imgs = _scene(b, h, w, 10000, seed=5)
    mn, mx = _thresholds(10000)
    taps = torch.from_numpy(gaussian_kernel(1.4))
    weak = torch.zeros((b, h, cdiv(w, 32)), dtype=torch.uint32)
    strong = torch.zeros_like(weak)
    ctl = torch.zeros(5, dtype=torch.int64)
    total = torch.zeros(1, dtype=torch.int64)
    flood = ctypes.CFUNCTYPE(ctypes.c_int, *SIGNATURES["hysteresis_packed"][
        "canny_hysteresis_packed"])(lambda *a: 0)
    args = kplan.Args(taps.data_ptr(), weak.data_ptr(), strong.data_ptr(),
                      None, ctl.data_ptr(), total.data_ptr(), None,
                      ctypes.cast(flood, ctypes.c_void_p).value, 0, b, h, w,
                      11, mn, mx, 0, 2)
    out = torch.zeros((b, h, w), dtype=torch.int16)
    run = kplan._RUN(("canny_run_plan", k1))
    assert run(ctypes.addressof(args), imgs.data_ptr(), out.data_ptr(), 1) == 0
    for i in range(b):
        (mw, ms), _, _ = _oracle_masks(imgs[i], 1.4, mn, mx)
        assert torch.equal(weak[i], mw) and torch.equal(strong[i], ms)


def test_cpu_model_takes_uint16_on_fused():
    """``CannyTorch(backend="fused")`` on CPU uint16 frames, one and a
    batch, gives the oracle's map; ``pallas`` and the strict mode refuse
    them and say which path takes them, after the thresholds' checks."""
    imgs = _scene(2, 48, 70, 10000, seed=11).numpy()
    mn, mx = _thresholds(10000)
    model = CannyTorch(1.4, device="cpu")
    want = np.stack([oracle.canny(f, 1.4, mn, mx) for f in imgs])
    assert (want == 255).any()
    np.testing.assert_array_equal(model(imgs[0], mn, mx).numpy(), want[0])
    np.testing.assert_array_equal(model.batch(imgs, mn, mx).numpy(), want)
    for kw in (dict(backend="pallas"),
               dict(hysteresis_mode="strict-reference")):
        other = CannyTorch(1.4, device="cpu", **kw)
        with pytest.raises(TypeError, match="uint16 frames are taken by "
                                            "backend 'fused'"):
            other(imgs[0], 30, 90)
        with pytest.raises(ValueError, match=r"range of \[0,255\]"):
            other(imgs[0], mn, mx)      # CannyTPU's order: range, then type
    with pytest.raises(ValueError, match=r"range of \[0,65535\]"):
        model(imgs[0], mn, 70000)


def test_plain_torch_equals_the_oracle_on_both_types():
    """The plain PyTorch reference gives the oracle's map on uint8 and
    uint16 frames, and its taps are the oracle's; it turns TF32 off only
    while it runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    for sigma in (0.8, 1.4, 2.8, 20.0):
        assert np.array_equal(plain_torch.gaussian_taps(sigma).numpy(),
                              oracle.gaussian_kernel(sigma))
    params = frames.frame_params(1, 60, 90, 21)
    for dtype, full in (("uint8", 255), ("uint16", 10000)):
        img = frames.make_pool(params, 60, 90, 21, torch.device("cpu"), 90,
                               dtype, full)[0]
        mn, mx = _thresholds(full)
        want = oracle.canny(img.numpy(), 1.4, mn, mx)
        assert (want == 255).any()
        np.testing.assert_array_equal(
            plain_torch.canny(img, 1.4, mn, mx).numpy(), want)
    assert torch.backends.cuda.matmul.allow_tf32 \
        and torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


def test_uint8_and_uint16_take_two_plans(monkeypatch):
    """One shape in both types takes two plans (the key holds the dtype);
    a uint16 request counts its frames in ``u16_frames``, a uint8 one
    none."""
    def build(key):
        p = kplan.Plan()
        p.shape, p.dtype, p.device = tuple(key[2]), torch.int16, \
            torch.device("cpu")
        p.addr, p.keep, p.spare, p.batch = 0, key, [], len(key[2]) == 3
        p.u16_frames = key[2][0] if key[3] == torch.uint16 else 0
        p.ring = (0, 0, 0, 0, 0)
        p.run = lambda *a: 0
        return p

    monkeypatch.setattr(kplan, "_plans", {})
    monkeypatch.setattr(kplan, "_build_plan", build)
    monkeypatch.setattr(kplan, "_raw_stream", lambda idx: 7)
    monkeypatch.setattr(kplan, "applies", lambda img, taps: True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    taps = torch.from_numpy(gaussian_kernel(1.4))
    first = entry_spans.counters()
    for dtype, n16 in ((torch.uint8, 0), (torch.uint16, 3), (torch.uint8, 0)):
        before = entry_spans.counters()
        kplan.run(torch.zeros((3, 16, 40), dtype=dtype), taps, (30, 90),
                  False, False)
        step = entry_spans.moved(before, entry_spans.counters())
        assert step["kernels.frontend.u16_frames"] == n16
        assert step["kernels.frontend.launches"] == 1
    total = entry_spans.moved(first, entry_spans.counters())
    assert total["kernels.plan.plan_builds"] == 2
    assert total["kernels.plan.plan_hits"] == 1 and len(kplan._plans) == 2


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.4, 2.8, 20.0, 110.0])
def test_card_uint16_equals_both_references(cuda_device, sigma):
    """The card's ``fused`` path on uint16 frames (a launch plan on the
    tile and ring paths, the wrappers past them) gives the oracle's and the
    plain PyTorch pipeline's map, a frame and a batch; its plans count
    their uint16 frames."""
    model = CannyTorch(sigma)
    imgs = torch.stack([_scene(1, 150, 230, 10000, seed=31)[0],
                        _step(150, 230, 65535)]).to(cuda_device)
    mn, mx = (1176, 3529) if sigma < 10 else (157, 471)
    before = kfe.u16_frames
    outs = [model(f, mn, mx) for f in imgs] + list(model.batch(imgs, mn, mx))
    assert kfe.u16_frames - before == 4
    for i, out in enumerate(outs):
        img = imgs[i % 2]
        want = oracle.canny(img.cpu().numpy(), sigma, mn, mx)
        np.testing.assert_array_equal(out.cpu().numpy(), want)
        assert torch.equal(out, plain_torch.canny(img, sigma, mn, mx))
