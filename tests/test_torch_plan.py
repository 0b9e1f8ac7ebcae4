"""The launch plans of the ``fused`` pipeline
(``canny_edge_tpu_torch/kernels/plan.py``): on the CPU their key, their
bounded cache and the bookkeeping of a request, with a stand-in build whose
plans record their call; on the card (``cuda`` marker) the plan path held
bit for bit to the wrappers' path (K1's wrapper, then K2's) and to the
plain version.  The C entry itself runs on the CPU under ``tools/cuda_emu``
(``tests/test_torch_emulated.py``)."""

import numpy as np
import pytest
import torch

from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.io.imageio import synthetic_image
from canny_edge_tpu_torch.kernels import _build
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.kernels import plan as kplan
from canny_edge_tpu_torch.models.canny import (MODES, canny_fn,
                                               canny_fn_packed)
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel

MN, MX = 30, 90


def _kern(window):
    kern = gaussian_kernel((window // 2 - 0.5) / 3)
    assert len(kern) == window
    return kern


def _counts():
    return (kfe.launches, kfe.batch_launches, kfe.ring_launches,
            khp.launches, khp.batch_launches, kplan.plan_builds,
            kplan.plan_hits)


def _moved(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _img(shape, dtype=torch.uint8):
    return torch.zeros(shape, dtype=dtype)


def test_plan_key_tells_every_configuration_apart():
    """Any change of device, stream, shape, input dtype, window, taps,
    bounds, strict rule or output kind gives another plan."""
    taps = torch.from_numpy(_kern(11))
    base = dict(idx=0, stream=7, img=_img((2, 40, 70)), taps=taps,
                bounds=(30, 90), strict=True, packed=False)
    twice = torch.from_numpy(np.repeat(_kern(11), 2))
    changes = [dict(idx=1), dict(stream=8), dict(img=_img((40, 70))),
               dict(img=_img((3, 40, 70))), dict(img=_img((2, 41, 70))),
               dict(img=_img((2, 40, 71))),
               dict(img=_img((2, 40, 70), torch.int16)),
               dict(taps=torch.from_numpy(_kern(19))),
               dict(taps=torch.from_numpy(_kern(11))),
               dict(taps=twice[::2]), dict(taps=taps.double()),
               dict(bounds=(31, 90)), dict(bounds=(30, 91)),
               dict(strict=False), dict(packed=True)]
    keys = [kplan.plan_key(**base)]
    keys += [kplan.plan_key(**{**base, **c}) for c in changes]
    assert len(set(keys)) == len(keys)


def test_plan_key_joins_what_the_kernels_take_alike():
    """Bounds that K1 compares alike (clamped to [-1, 2**13]), and the
    strict rule where K2 does not apply it (fewer than two rows or
    columns), give one plan."""
    taps = torch.from_numpy(_kern(11))

    def key(shape, bounds, strict=False):
        return kplan.plan_key(0, 7, _img(shape), taps, bounds, strict, False)

    assert key((40, 70), (-5, 9000)) == key((40, 70), (-1, 1 << 13))
    assert key((40, 70), (-5, 9000)) != key((40, 70), (0, 1 << 13))
    for shape in ((1, 70), (40, 1), (3, 1, 70)):
        assert key(shape, (30, 90), True) == key(shape, (30, 90))
    assert key((2, 70), (30, 90), True) != key((2, 70), (30, 90))


GEOMETRY_CALLS = []


def _ring_geometry(b, oh, ow, window, device, itemsize=1):
    """A stand-in for the library's ring geometry: numbers of its shape."""
    GEOMETRY_CALLS.append((b, oh, ow, window))
    return kfe.RingGeometry(132, ow, 2 * b * ow, oh, b * ow,
                            b * ow * (oh + window), b * ow * oh)


def _ring():
    return (kfe.ring_launches, kfe.ring_blocks, kfe.ring_segments,
            kfe.ring_xpass_rows, kfe.ring_out_rows)


@pytest.fixture
def stand_in(monkeypatch):
    """``kernels.plan`` on the CPU with an empty cache, every tensor taken
    for a card's and every request for one that takes a plan, and a
    stand-in build: a plan whose launch records ``(key, img, out, token)``
    and returns 0."""
    calls = []

    def build(key):
        shape, window = key[2], key[5][0]
        b = shape[0] if len(shape) == 3 else 1
        p = kplan.Plan()
        p.shape, p.dtype = tuple(shape), torch.int16
        p.device, p.addr, p.keep = torch.device("cpu"), 0, key
        p.batch = len(shape) == 3 and shape[0] > 1
        p.u16_frames = 0
        p.ring = kfe.ring_counts(b, *shape[-2:], window, p.device)
        p.run = lambda addr, img, out, token: calls.append(
            (key, img, out, token)) or 0
        p.spare = []
        return p

    monkeypatch.setattr(kplan, "_plans", {})
    monkeypatch.setattr(kplan, "_build_plan", build)
    monkeypatch.setattr(kfe, "max_window", lambda dev, itemsize=1: 613)
    monkeypatch.setattr(kfe, "ring_geometry", _ring_geometry)
    monkeypatch.setattr(kplan, "_raw_stream", lambda idx: 7)
    monkeypatch.setattr(kplan, "applies", lambda img, taps: True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    return calls


def test_plan_cache_keeps_the_most_recently_used(stand_in):
    taps = torch.from_numpy(_kern(11))
    n = kplan.MAX_PLANS
    imgs = [torch.zeros((8 + i, 16), dtype=torch.uint8) for i in range(n + 1)]

    def request(i):
        before = _counts()
        kplan.run(imgs[i], taps, (MN, MX), False, False)
        return _moved(before)[-2:]          # (builds, hits)

    assert [request(i) for i in range(n)] == [(1, 0)] * n
    assert request(0) == (0, 1)             # now the most recently used
    assert request(n) == (1, 0)             # makes room: imgs[1]'s goes
    assert len(kplan._plans) == n
    assert request(0) == (0, 1) and request(1) == (1, 0)
    assert len(kplan._plans) == n


def test_a_plan_request_counts_its_launches_and_gives_a_fresh_output(
        stand_in):
    """Each request moves K1's and K2's launch counters as their wrappers
    would, takes a fresh token and returns a fresh output, the one made
    after the previous request's launch; a view that is not contiguous is
    copied first, as K1's wrapper copies it."""
    taps = torch.from_numpy(_kern(11))
    batch = torch.zeros((3, 8, 16), dtype=torch.uint8)
    before = _counts()
    outs = [kplan.run(batch, taps, (MN, MX), False, False) for _ in range(2)]
    assert _moved(before) == (2, 2, 0, 2, 2, 1, 1)
    (k0, i0, o0, t0), (k1, i1, o1, t1) = stand_in
    assert k0 == k1 and i0 == i1 == batch.data_ptr() and t0 < t1
    assert (o0, o1) == tuple(o.data_ptr() for o in outs) and o0 != o1
    assert all(o.shape == batch.shape and o.dtype == torch.int16
               for o in outs)
    # the next request's output is made after the launch, and kept
    [plan] = kplan._plans.values()
    [spare] = plan.spare
    assert spare.data_ptr() not in (o0, o1)
    assert kplan.run(batch, taps, (MN, MX), False, False) is spare
    view = batch.transpose(1, 2)
    kplan.run(view, taps, (MN, MX), False, False)
    assert stand_in[-1][1] not in (view.data_ptr(), batch.data_ptr())


def test_ring_counters_advance_by_a_plans_geometry(stand_in):
    """A request on a plan of K1's ring path adds one launch and the
    geometry its plan worked out once, at its build, to K1's ring counters;
    one on a tile plan adds nothing."""
    batch = torch.zeros((3, 24, 40), dtype=torch.uint8)
    GEOMETRY_CALLS.clear()
    for window, per in ((121, (1, 120, 240, 120 * 145, 120 * 24)),
                        (11, (0, 0, 0, 0, 0))):
        taps = torch.from_numpy(_kern(window))
        before = _ring()
        for _ in range(3):
            kplan.run(batch, taps, (4, 12), False, False)
        moved = tuple(a - b for a, b in zip(_ring(), before))
        assert moved == tuple(3 * n for n in per), window
    assert GEOMETRY_CALLS == [(3, 24, 40, 121)]


@pytest.mark.parametrize("err,msg,moved", [
    (5, "canny_frontend launch: CUDA error 5", (0, 0)),
    (-7, "canny_hysteresis_packed launch: CUDA error 7", (1, 0))])
def test_a_failed_launch_raises_as_its_wrapper_does(stand_in, monkeypatch,
                                                    err, msg, moved):
    """K1's error (positive) as K1's wrapper raises it, with no launch
    counted; K2's (negated) as K2's, with K1's launch counted."""
    build = kplan._build_plan

    def failing(key):
        p = build(key)
        p.run = lambda *args: err
        return p

    monkeypatch.setattr(kplan, "_build_plan", failing)
    before = _counts()
    with pytest.raises(RuntimeError, match=msg):
        kplan.run(torch.zeros((8, 16), dtype=torch.uint8),
                  torch.from_numpy(_kern(11)), (MN, MX), False, False)
    assert (_moved(before)[0], _moved(before)[3]) == moved


def test_cpu_requests_take_no_plan():
    model = CannyTorch(1.4, device="cpu")
    frames = np.stack([synthetic_image(24, 40, seed=s) for s in range(2)])
    assert not kplan.applies(torch.from_numpy(frames[0]), model.taps)
    before = _counts()
    model(frames[0], MN, MX)
    model.packed(frames[0], MN, MX)
    model.batch(frames, MN, MX)
    canny_fn(torch.from_numpy(frames), MN, MX, kernel_vals=model.taps,
             backend="fused")
    # no plan, and no launch: the wrappers ran their plain versions
    assert _moved(before) == (0,) * 7


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda", torch.cuda.current_device())


def _wrappers(img, taps, strict, packed):
    """The wrappers' path on the card: K1's wrapper, then K2's."""
    h, w = img.shape[-2:]
    weak, strong = kfe.frontend(img, taps, (MN, MX))
    return khp.hysteresis_packed(weak, strong, h, w, strict=strict,
                                 edges_int16=not packed)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [11, 19, 121])
def test_card_plan_equals_the_wrappers_and_the_plain_version(cuda_device,
                                                             window):
    """Every model method and mode on the tile path (11, 19 taps) and the
    ring path (121): one plan lookup and one launch of K1 and of K2 a
    request (on the ring path with its geometry in the ring counters), the
    edges those of the wrappers and of the plain version; at 121 taps a
    batch of 8 1080p frames adds the ring geometry of 132 spans across
    strips and frames."""
    kern = _kern(window)
    frames = torch.from_numpy(np.stack([synthetic_image(72, 100, seed=s)
                                        for s in range(3)]))
    imgs = frames.to(cuda_device)
    for mode in MODES:
        card = CannyTorch.from_numpy_params(kern, hysteresis_mode=mode)
        cpu = CannyTorch.from_numpy_params(kern, hysteresis_mode=mode,
                                           device="cpu")
        for name in ("__call__", "packed", "batch", "batch_packed"):
            one = name in ("__call__", "packed")
            x, host = (imgs[0], frames[0]) if one else (imgs, frames)
            before, ring_before = _counts(), _ring()
            got = getattr(card, name)(x, MN, MX)
            b = int(not one)
            ring = int(window == 121)
            assert _moved(before)[:5] == (1, b, ring, 1, b)
            assert sum(_moved(before)[5:]) == 1
            g = kfe.ring_geometry(1 if one else 3, 72, 100, 121, cuda_device)
            assert tuple(a - b for a, b in zip(_ring(), ring_before)) == \
                ((1, g.blocks, g.segments, g.xpass_rows, g.out_rows) if ring
                 else (0, 0, 0, 0, 0))
            want = _wrappers(x, card.taps, mode == "strict-reference",
                             "packed" in name)
            assert torch.equal(got, want), (name, mode)
            assert torch.equal(got.cpu(), getattr(cpu, name)(host, MN, MX))
    if window == 121:
        # the wide cell's shape: a plan's counters are the launch rule's
        # 132 spans of at most 62 steps (360 segments) on the H100's 132
        # co-resident blocks
        card = CannyTorch.from_numpy_params(kern)
        wide = torch.from_numpy(np.stack([
            synthetic_image(1080, 1920, seed=s) for s in range(8)])).to(
                cuda_device)
        ring_before = _ring()
        got = card.batch(wide, MN, MX)
        assert tuple(a - b for a, b in zip(_ring(), ring_before)) == \
            (1, 132, 360, 360 * 124 + 32 * 8160, 240 * 1080)
        assert kfe.ring_geometry(8, 1080, 1920, 121, cuda_device)[:5] == \
            (132, 30, 360, 62, 132)
        assert torch.equal(got, _wrappers(wide, card.taps, False, False))


@pytest.mark.cuda
def test_card_window_past_the_ring_takes_the_wrappers(cuda_device):
    kern = gaussian_kernel(103.0)
    assert len(kern) > kfe.max_window(cuda_device)
    frame = synthetic_image(40, 64, seed=1)
    model = CannyTorch.from_numpy_params(kern)
    before, scratch = _counts(), kfe.scratch_launches
    got = model(torch.from_numpy(frame).to(cuda_device), MN, MX)
    assert kfe.scratch_launches - scratch == 1
    assert _moved(before)[-2:] == (0, 0)
    cpu = CannyTorch.from_numpy_params(kern, device="cpu")
    assert torch.equal(got.cpu(), cpu(frame, MN, MX))


@pytest.mark.cuda
def test_card_plans_follow_thresholds_shapes_and_streams(cuda_device,
                                                         monkeypatch):
    """Thresholds and shapes that change between calls, the functional
    entry points, a second stream: a plan for each configuration, found
    again when it returns, every result the plain version's."""
    monkeypatch.setattr(kplan, "_plans", {})
    model, cpu = CannyTorch(1.4), CannyTorch(1.4, device="cpu")
    frames = {hw: synthetic_image(*hw, seed=hw[0]) for hw in ((72, 100),
                                                            (73, 99))}
    on_card = {hw: torch.from_numpy(f).to(cuda_device)
               for hw, f in frames.items()}
    before = _counts()
    for hw, mn, mx in [((72, 100), 30, 90), ((72, 100), 20, 60),
                       ((73, 99), 20, 60), ((72, 100), 30, 90)]:
        got = model(on_card[hw], mn, mx)
        assert torch.equal(got.cpu(), cpu(frames[hw], mn, mx)), (hw, mn, mx)
    assert _moved(before)[-2:] == (3, 1)
    img = on_card[(72, 100)]
    before = _counts()
    got = canny_fn(img, 30.5, 90, kernel_vals=model.taps, backend="fused")
    assert torch.equal(got.cpu(), canny_fn(frames[(72, 100)], 30.5, 90,
                                           kernel_vals=model.taps,
                                           backend="fused", device="cpu"))
    got = canny_fn_packed(img, 30, 90, kernel_vals=model.taps)
    assert torch.equal(got.cpu(), cpu.packed(frames[(72, 100)], 30, 90))
    assert _moved(before)[-2:] == (2, 0)     # 30.5 compares as 31
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    before = _counts()
    with torch.cuda.stream(side):
        got = model(img, 30, 90)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    assert _moved(before)[-2:] == (1, 0)
    assert torch.equal(got.cpu(), cpu(frames[(72, 100)], 30, 90))
    model(img, 30, 90)
    assert _moved(before)[-2:] == (1, 1)


@pytest.mark.cuda
def test_card_kept_outputs_do_not_alias_and_steps_count(cuda_device):
    """Two outputs in a row that the caller keeps are two tensors, each
    right; a request adds its K2 launch's steps to ``flood_steps()``."""
    model, cpu = CannyTorch(1.4), CannyTorch(1.4, device="cpu")
    frames = [synthetic_image(72, 100, seed=s) for s in (5, 6)]
    imgs = [torch.from_numpy(f).to(cuda_device) for f in frames]
    model(imgs[0], MN, MX)                   # the plan is built
    launches = khp.launches
    outs = [model(x, MN, MX) for x in imgs]
    assert outs[0].data_ptr() != outs[1].data_ptr()
    for out, f in zip(outs, frames):
        assert torch.equal(out.cpu(), cpu(f, MN, MX))
    key = kplan.plan_key(cuda_device.index,
                         _build.stream_handle(cuda_device), imgs[1],
                         model.taps, (MN, MX), False, False)
    ctl = kplan._plans[key].keep[0]["ctl"]   # K2's last count is its last
    steps = khp.flood_steps()
    model(imgs[1], MN, MX)
    assert khp.flood_steps() - steps == int(ctl[-1]) >= 1
    assert khp.launches - launches == 3
