"""16-bit frames in the benchmark, on the CPU at small sizes: a
configuration's ``dtype`` and ``full_scale`` reach the frames, the oracle,
the pool and K1's floor, and every 8-bit answer stays what it was.

The 8-bit pins: the pools' digests as the generator made them before it
took a frame type, every oracle stage against the port's copy of the NumPy
golden model (``canny_edge_tpu_torch.golden``, whose functions are those of
the JAX package's ``golden``; the benchmark's sources import nothing of the
JAX package), and K1's floor by its formula.  The 16-bit proof: the widened
oracle against the port's plain path (``backend="xla"`` on the CPU: int64
squares), and a run of a 16-bit cell built here, not in
``BENCHMARK.json``, whose model is a stand-in on that plain path, since
the port's ``fused`` path refuses 16-bit frames."""

import hashlib
import json
import math
import time

import numpy as np
import pytest
import torch

from canny_edge_tpu_torch import golden
from canny_edge_tpu_torch.models.canny import canny_fn
from portbench import run
from portbench.harness import spec
from portbench.reference import frames, oracle
from portbench.reference.compare import oracle_edges

CPU = torch.device("cpu")
K1 = spec.load_metric("k1_roofline")

# sha256 of the uint8 pools that make_pool gave before it took a frame
# type: (frames, height, width, scene width), seed -> digest
POOL_DIGESTS = {
    ((3, 40, 64, 64), 2200000501):
        "1e41f0a897d7d305d2641de83f01cf10643b35f9b23e8050996969ce9637de48",
    ((3, 40, 64, 64), 2**40 + 7):
        "4b38cd1172f04b774825df87741d0d93225535a37ae8c018f9e6f055022cc46e",
    ((2, 72, 128, 64), 2200000501):
        "d80c8be5eb861db68b9797866ab562369113a5f610c5b7a49a3c9a1a4d96c32f",
    ((2, 72, 128, 64), 2**40 + 7):
        "ee704d42b4c4a2d157d0c26647d14688ab53d463357e6c3d05514319d543b21a",
}


def pool(n, h, w, seed, scene_width=None, *frame):
    params = frames.frame_params(n, h, w, seed)
    return frames.make_pool(params, h, w, seed, CPU, scene_width or w, *frame)


def plain(frame, sigma, lo, hi, mode, taps=None):
    """The port's plain path on the CPU, the semantics 16-bit frames take."""
    taps = oracle.gaussian_kernel(sigma) if taps is None else taps
    return canny_fn(torch.from_numpy(frame), lo, hi, kernel_vals=taps,
                    backend="xla", hysteresis_mode=mode, device="cpu").numpy()


def scaled(full_scale, sigma):
    """cam1080's thresholds 30/90 at the frame's white level, and at a
    wider blur (whose gradient is smaller) in proportion."""
    f = full_scale / 255 * 1.4 / sigma
    return round(30 * f), round(90 * f)


# uint8 pools ----------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", sorted(POOL_DIGESTS))
def test_uint8_pools_are_the_parents(shape, seed):
    n, h, w, sw = shape
    for x in (pool(n, h, w, seed, sw), pool(n, h, w, seed, sw, "uint8", 255)):
        assert x.dtype == torch.uint8
        assert hashlib.sha256(x.numpy().tobytes()).hexdigest() == \
            POOL_DIGESTS[shape, seed]


# uint16 pools ---------------------------------------------------------------

@pytest.mark.parametrize("full_scale", [4095, 10000, 65535])
def test_uint16_pools_take_the_white_level(full_scale):
    """The 8-bit scene's levels times ``full_scale / 255``, clipped at the
    white level: the pixels that saturate at 255 saturate at it."""
    seed, level = 2**36 + 11, full_scale / 255
    p8 = pool(4, 150, 240, seed).numpy().astype(np.int64)
    p16 = pool(4, 150, 240, seed, None, "uint16", full_scale)
    assert p16.dtype == torch.uint16 and p16.shape == (4, 150, 240)
    x = p16.numpy().astype(np.int64)
    assert x.min() >= 0 and x.max() == full_scale
    assert (p8 == 255).any()
    assert np.mean(x[p8 == 255] == full_scale) > 0.95
    inside = (p8 > 0) & (p8 < 255)
    assert np.abs(x[inside] - p8[inside] * level).max() <= level + 1
    assert torch.equal(p16, pool(4, 150, 240, seed, None, "uint16",
                                 full_scale))


def test_uint16_pool_at_255_is_the_uint8_pool():
    a = pool(2, 72, 128, 2200000501, 64)
    b = pool(2, 72, 128, 2200000501, 64, "uint16", 255)
    assert np.array_equal(a.numpy(), b.numpy())


# the oracle's stages on uint8 frames ----------------------------------------

@pytest.mark.parametrize("sigma,lo,hi", [(1.4, 30, 90), (2.8, 15, 45),
                                         (20.0, 4, 12)])
def test_uint8_stages_are_golden(sigma, lo, hi):
    """Every stage of the widened oracle, now carried as int32, gives the
    values of the golden model's int16 stages, and the maps agree."""
    edges = 0
    for frame in pool(2, 60, 96, 2**33 + 41).numpy():
        blur = oracle.gaussian_blur(frame, sigma)
        assert blur.dtype == np.int32
        np.testing.assert_array_equal(blur, golden.gaussian_blur(frame, sigma))
        gx, gy = oracle.xy_gradient(blur)
        for ours, theirs in zip((gx, gy), golden.xy_gradient(blur)):
            np.testing.assert_array_equal(ours, theirs)
        mag, ang = oracle.sobel(blur)
        gmag, gang = golden.sobel(blur.astype(np.int16))
        np.testing.assert_array_equal(mag, gmag)
        np.testing.assert_array_equal(ang, gang)
        nm = oracle.nonmax_suppression(mag, ang)
        gnm = golden.nonmax_suppression(gmag, gang)
        np.testing.assert_array_equal(nm, gnm)
        for ours, theirs in ((oracle.hysteresis(nm, lo, hi),
                              golden.hysteresis(gnm, lo, hi)),
                             (oracle.hysteresis_strict(nm, lo, hi),
                              golden.hysteresis_bfs(gnm, lo, hi)),
                             (oracle_edges(frame, sigma, lo, hi, "component"),
                              golden.canny(frame, sigma, lo, hi))):
            assert ours.dtype == np.int16
            np.testing.assert_array_equal(ours, theirs)
        edges += np.count_nonzero(oracle.hysteresis(nm, lo, hi))
    assert edges > 0


def test_empty_hysteresis_is_int16():
    nm = np.zeros((5, 7), np.int32)
    for fn in (oracle.hysteresis, oracle.hysteresis_strict,
               oracle.hysteresis_bfs):
        out = fn(nm, 10, 20)
        assert out.dtype == np.int16 and not out.any()


def test_strict_marks_apart_equal_the_literal_bfs():
    """The strict oracle keeps its BFS marks apart from the magnitudes; on
    maps whose thresholds are at most 255 it is the literal in-place BFS,
    the reference's row-1 quirk included."""
    rng = np.random.default_rng(2**34 + 5)
    for _ in range(400):
        h, w = rng.integers(1, 9, 2)
        nm = rng.integers(0, 60, (h, w)).astype(np.int32)
        lo, hi = sorted(int(v) for v in rng.integers(0, 60, 2))
        if rng.random() < 0.2:
            lo, hi = hi, lo
        np.testing.assert_array_equal(oracle.hysteresis_strict(nm, lo, hi),
                                      oracle.hysteresis_bfs(nm, lo, hi))
    quirk = np.array([[0, 5, 0], [9, 0, 0]], np.int32)
    assert oracle.hysteresis_strict(quirk, 5, 9)[0, 1] == 0
    assert oracle.hysteresis(quirk, 5, 9)[0, 1] == 255


def test_strict_past_255_is_the_ports_strict_path():
    """On an 8-bit step whose magnitudes pass 255, thresholds past 255: the
    literal BFS clears its own marks (255 < ``max_val``), the oracle with
    its marks apart gives the port's strict edges."""
    yy, xx = np.mgrid[:40, :60]
    frame = np.where(xx + yy // 2 > 40, 255, 0).astype(np.uint8)
    nm = oracle.nonmax_suppression(*oracle.sobel(
        oracle.gaussian_blur(frame, 1.4)))
    assert nm.max() > 400
    ours = oracle_edges(frame, 1.4, 260, 300, "strict-reference")
    assert np.count_nonzero(ours) > 0
    assert not oracle.hysteresis_bfs(nm, 260, 300).any()
    np.testing.assert_array_equal(
        ours, plain(frame, 1.4, 260, 300, "strict-reference"))


# the oracle on uint16 frames ------------------------------------------------

@pytest.mark.parametrize("mode", ["component", "strict-reference"])
@pytest.mark.parametrize("sigma", [1.4, 2.8])
@pytest.mark.parametrize("full_scale", [4095, 65535])
def test_uint16_oracle_is_the_ports_plain_path(full_scale, sigma, mode):
    lo, hi = scaled(full_scale, sigma)
    edges = 0
    for seed in (2**35 + 1, 2**35 + 2, 2200000501):
        frame = pool(1, 48, 80, seed, None, "uint16", full_scale)[0].numpy()
        assert frame.dtype == np.uint16
        ours = oracle_edges(frame, sigma, lo, hi, mode)
        assert ours.dtype == np.int16
        np.testing.assert_array_equal(ours, plain(frame, sigma, lo, hi, mode))
        edges += np.count_nonzero(ours)
    assert edges > 0


def test_uint16_step_passes_int32_squares():
    """A full-range diagonal step: gx^2 + gy^2 passes 2^31 and NMS passes
    int16; the magnitude is the integer square root, and the maps are the
    port's plain path's."""
    yy, xx = np.mgrid[:48, :64]
    frame = np.where(xx + yy > 50, 65535, 0).astype(np.uint16)
    frame[5:15, 5:15] = 40000
    blur = oracle.gaussian_blur(frame, 1.4)
    assert blur.max() == 65535
    gx, gy = oracle.xy_gradient(blur)
    n = gx.astype(np.int64) ** 2 + gy.astype(np.int64) ** 2
    assert n.max() > 2**31
    mag = oracle.magnitude_int(gx, gy)
    assert mag.dtype == np.int32
    assert [math.isqrt(int(v)) for v in n.ravel()] == mag.ravel().tolist()
    nm = oracle.nonmax_suppression(mag, oracle.quantize_angle(gx, gy))
    assert nm.max() > 32767
    for mode in ("component", "strict-reference"):
        ours = oracle_edges(frame, 1.4, 20000, 60000, mode)
        assert np.count_nonzero(ours) > 0
        np.testing.assert_array_equal(
            ours, plain(frame, 1.4, 20000, 60000, mode))


# a 16-bit cell's run --------------------------------------------------------

CONFIG16 = {
    "name": "band16", "height": 120, "width": 200, "scene_width": 200,
    "sigma": 1.4, "min_val": scaled(4095, 1.4)[0],
    "max_val": scaled(4095, 1.4)[1], "backend": "xla",
    "hysteresis_mode": "component", "dtype": "uint16", "full_scale": 4095,
    "reduced": []}


class PlainModel:
    """A stand-in for the model class on the port's plain path, which
    takes 16-bit frames; ``fault``: one pixel of every answer flipped."""

    def __init__(self, config, taps=None, fault=False):
        self.sigma = config["sigma"]
        self.mode = config["hysteresis_mode"]
        self.taps = taps
        self.fault = fault

    def __call__(self, x, lo, hi):
        out = torch.from_numpy(plain(x.numpy(), self.sigma, lo, hi, self.mode,
                                     self.taps))
        if self.fault:
            out[7, 9] ^= 255
        return out


def run16(make_model, seed=2**33 + 77):
    bench = spec.load_benchmark()
    e2e = [m for m in bench["end_to_end"]
           if m["name"] in ("mpix_per_s.live", "setup_s")]
    h, w = CONFIG16["height"], CONFIG16["width"]
    traffic = dict(spec.load_traffic("live"), pool_bytes=6 * h * w * 2,
                   sample_pixels=6 * h * w)
    cell = spec.Cell("band16.live", 1, CONFIG16, traffic,
                     spec.driver_path("closed"), e2e, [])
    driver = spec.load_driver(cell)
    plan = driver.plan(cell.config, cell.traffic, seed)
    assert plan["pool_frames"] == 6 and plan["pool_bytes"] == 6 * h * w * 2
    readers = [(m, spec.load_metric(m["name"])) for m in e2e]
    return run.measure(cell, driver, plan, readers, seconds=0.5, trace=False,
                       device=CPU, make_model=make_model,
                       t_start=time.perf_counter())


def test_uint16_cell_is_correct():
    res = run16(lambda c, d: PlainModel(c))
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["frames_checked"]["value"] >= 6
    assert res["info"]["pool_bytes"] == 6 * 120 * 200 * 2
    assert {"mpix_per_s.live", "setup_s"} <= set(res["metrics"])


def test_uint16_cell_with_a_planted_pixel_is_not_correct():
    res = run16(lambda c, d: PlainModel(c, fault=True))
    assert res["correct"] is False
    assert res["checks"]["mismatched_px"]["value"] >= 6


def test_uint16_cell_with_the_controls_taps_is_not_correct():
    """The control's taps (the float32 taps rounded to bfloat16, as
    ``harness/program.py:make_control_model`` rounds them) on the plain
    path."""
    taps = torch.from_numpy(oracle.gaussian_kernel(CONFIG16["sigma"]))
    taps = taps.to(torch.bfloat16).to(torch.float32).numpy()
    res = run16(lambda c, d: PlainModel(c, taps=taps))
    assert res["correct"] is False
    assert res["checks"]["mismatched_px"]["value"] > 0


# the frame type's check -----------------------------------------------------

@pytest.mark.parametrize("keys,ok", [
    ({}, ("uint8", 255)),
    ({"dtype": "uint8"}, ("uint8", 255)),
    ({"dtype": "uint8", "full_scale": 200}, ("uint8", 200)),
    ({"dtype": "uint16"}, ("uint16", 255)),
    ({"dtype": "uint16", "full_scale": 4095}, ("uint16", 4095)),
    ({"dtype": "uint16", "full_scale": 65535}, ("uint16", 65535)),
    ({"dtype": "int16"}, None),
    ({"dtype": "float32"}, None),
    ({"dtype": "uint32"}, None),
    ({"full_scale": 256}, None),
    ({"full_scale": 0}, None),
    ({"dtype": "uint16", "full_scale": 65536}, None),
    ({"dtype": "uint16", "full_scale": 4095.0}, None),
    ({"dtype": "uint16", "full_scale": "4095"}, None),
    ({"full_scale": True}, None),
])
def test_frame_type(keys, ok):
    config = dict({"name": "c"}, **keys)
    if ok is not None:
        assert spec.frame_type(config) == ok
    else:
        with pytest.raises(ValueError, match="configuration 'c'"):
            spec.frame_type(config)


@pytest.mark.parametrize("keys", [{"dtype": "int16"},
                                  {"dtype": "uint16", "full_scale": 70000}])
def test_resolve_refuses_a_bad_frame_type(tmp_path, keys):
    bench_dir = tmp_path / "portbench"
    bench_dir.mkdir()
    for d in ("traffic", "drivers", "metrics"):
        (bench_dir / d).symlink_to(spec.ROOT / "portbench" / d)
    (bench_dir / "bad.json").write_text(json.dumps(dict(CONFIG16, **keys)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "bad", "file": "portbench/bad.json"}],
        "workloads": [{"name": "bad.live", "config": "bad",
                       "traffic": "live", "chips": 1}],
        "end_to_end": [{"name": "setup_s"}], "per_layer": []}))
    with pytest.raises(ValueError, match="configuration 'band16'"):
        spec.resolve("bad.live", tmp_path)


# K1's floor -----------------------------------------------------------------

@pytest.mark.parametrize("h,w,window", [(1080, 1920, 11), (2160, 3840, 19),
                                        (1080, 1920, 121)])
def test_uint8_k1_floor_is_unchanged(h, w, window):
    """The floor as it stood, for the cells' shapes and windows."""
    kind = "NVIDIA H100 80GB HBM3"
    before = max((h * w + 2 * h * math.ceil(w / 32) * 4) / 3.35e12,
                 h * w * (4 * window + 45) / 33.5e12)
    assert K1.frame_floor_s(h, w, window, kind) == before
    assert K1.frame_floor_s(h, w, window, kind, 1) == before


class FakeRun:
    def __init__(self, **config):
        self.config = dict({"height": 1080, "width": 1920, "sigma": 1.4},
                           **config)
        self.device_kind = "NVIDIA H100 80GB HBM3"
        self.frames_per_request = 1


def test_k1_floor_counts_the_frames_bytes(monkeypatch):
    """Two bytes a uint16 pixel in; the operations are the same work
    whatever the type.  (At the card's rates K1's operations bind, so the
    bytes show where the operation rate is set past them.)"""
    assert K1.frame_bytes(1080, 1920, 2) - K1.frame_bytes(1080, 1920, 1) \
        == 1080 * 1920
    assert K1.floor_s(FakeRun()) == K1.floor_s(FakeRun(dtype="uint8")) == \
        K1.frame_floor_s(1080, 1920, 11, "NVIDIA H100 80GB HBM3")
    monkeypatch.setitem(K1.PEAKS, "NVIDIA H100 80GB HBM3",
                        {"hbm_bytes_per_s": 3.35e12, "ops_per_s": 1e30})
    one = K1.floor_s(FakeRun(dtype="uint16", full_scale=255))
    assert one == K1.frame_bytes(1080, 1920, 2) / 3.35e12
    assert one > K1.floor_s(FakeRun())
