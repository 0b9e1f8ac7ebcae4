"""PyTorch port, the modules around the command line: ``config``, ``io``
(with the standard-library PNG/PGM path against OpenCV), the native feeder
(``runtime``), ``parallel.streaming``, ``utils.timing`` and ``utils.trace``,
against the JAX package's copies where they exist, bit for bit.
"""

import json
import os
import threading
import zlib

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu.config import CannyConfig as JaxConfig
from canny_edge_tpu.io import imageio as jax_io
from canny_edge_tpu.io import video as jax_video
from canny_edge_tpu_torch import CannyTorch, runtime
from canny_edge_tpu_torch.config import CannyConfig
from canny_edge_tpu_torch.io import imageio, video
from canny_edge_tpu_torch.parallel.streaming import (DevicePrefetcher,
                                                     StreamCursor,
                                                     StreamingRunner)
from canny_edge_tpu_torch.utils import timing


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def no_codecs(monkeypatch):
    """The image module as it is on a machine without OpenCV and Pillow."""
    monkeypatch.setattr(imageio, "cv2", None)
    monkeypatch.setattr(imageio, "Image", None)


@pytest.fixture
def feeder():
    if not runtime.available():
        pytest.skip(f"native feeder unavailable: {runtime._state['error']}")
    return runtime


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"min_val": 150, "max_val": 50}, {"min_val": -1}, {"max_val": 256},
    {"sigma": 0.0}, {"backend": "cuda"}, {"hysteresis_mode": "bfs"},
    {"batch_size": 0}, {"prefetch_depth": 0}])
def test_config_messages_equal_jax(kw):
    with pytest.raises(ValueError) as ours:
        CannyConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_config_fields_and_backends_equal_jax():
    for kw in ({}, {"sigma": 1.4, "backend": "golden", "batch_size": 8,
                    "checkpoint_path": "c.json", "packed_transfer": True}):
        assert CannyConfig(**kw).to_dict() == JaxConfig(**kw).to_dict()
    for b in ("fused", "xla", "pallas", "sharded", "golden"):
        assert CannyConfig(backend=b).backend == JaxConfig(backend=b).backend


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,seed", [(32, 48, 0), (61, 17, 9), (1080, 1920, 5)])
def test_synthetic_image_equals_jax(h, w, seed):
    np.testing.assert_array_equal(imageio.synthetic_image(h, w, seed),
                                  jax_io.synthetic_image(h, w, seed))


def test_bgr_to_gray_and_minmax_equal_jax():
    import cv2

    bgr = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    np.testing.assert_array_equal(imageio.bgr_to_gray(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(imageio.bgr_to_gray(bgr),
                                  jax_io.bgr_to_gray(bgr))
    for img in (np.array([[-100, 0], [100, 300]], np.int16),
                np.full((4, 4), 7), np.arange(-50, 950, dtype=np.int32)):
        np.testing.assert_array_equal(imageio.minmax_normalize_u8(img),
                                      jax_io.minmax_normalize_u8(img))


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 128)])
def test_builtin_png_writer_read_by_opencv(shape, tmp_path, no_codecs):
    import cv2

    img = np.random.default_rng(shape[0]).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "x")                 # ".png" is added
    imageio.save_png(path, img)
    np.testing.assert_array_equal(
        cv2.imread(path + ".png", cv2.IMREAD_GRAYSCALE), img)
    np.testing.assert_array_equal(imageio.load_grayscale(path + ".png"), img)


def test_builtin_png_reader_takes_every_filter(tmp_path, no_codecs):
    """OpenCV picks row filters adaptively; a smooth image with noise makes
    it use several."""
    import cv2

    img = np.clip(imageio.synthetic_image(80, 120, seed=3).astype(int)
                  + np.arange(120)[None] // 3, 0, 255).astype(np.uint8)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(imageio.read_png(data), img)
    rows = np.frombuffer(zlib.decompress(
        data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]), np.uint8)
    assert len(set(rows.reshape(80, 121)[:, 0].tolist())) > 1
    np.testing.assert_array_equal(imageio.load_grayscale(path), img)


def test_builtin_pgm_reader_vs_opencv(tmp_path, no_codecs):
    import cv2

    img = np.random.default_rng(2).integers(0, 256, (16, 24), np.uint8)
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5\n# a comment\n24 # width\n16\n255\n" + img.tobytes())
    np.testing.assert_array_equal(imageio.load_grayscale(str(p)), img)
    np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_GRAYSCALE),
                                  img)
    imageio.save_png(str(tmp_path / "w.pgm"), img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "w.pgm"), cv2.IMREAD_GRAYSCALE), img)


def test_builtin_readers_refuse_what_they_cannot_read(tmp_path, no_codecs):
    import cv2

    img = np.zeros((8, 8, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    cv2.imwrite(str(tmp_path / "c.jpg"), img)
    (tmp_path / "t.pgm").write_bytes(b"P5\n8 8\n255\n" + bytes(10))
    (tmp_path / "m.pgm").write_bytes(b"P5\n2 2\n15\n" + bytes(4))
    for name, msg in (("c.png", "colour type 2"), ("c.jpg", "without OpenCV"),
                      ("t.pgm", "holds 10 bytes"), ("m.pgm", "maxval 255")):
        with pytest.raises(ValueError, match=msg):
            imageio.load_grayscale(str(tmp_path / name))
    with pytest.raises(ValueError, match="without OpenCV"):
        imageio.save_png(str(tmp_path / "x.jpg"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="needs OpenCV"):
        video.frames_from_video(str(tmp_path / "v.mp4"))
    data = bytearray(imageio.png_bytes(np.zeros((4, 4), np.uint8)))
    data[-20] ^= 1                             # inside the IDAT chunk
    with pytest.raises(ValueError, match="corrupt"):
        imageio.read_png(bytes(data))


def test_sources_and_batches_equal_jax(tmp_path):
    ours = list(video.open_source("synthetic:32x48x5"))
    theirs = list(jax_video.open_source("synthetic:32x48x5"))
    assert len(ours) == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for pad in (False, True):
        got = list(video.batched(iter(ours), 2, pad_to_full=pad))
        want = list(jax_video.batched(iter(theirs), 2, pad_to_full=pad))
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for i, f in enumerate(ours[:3]):
        imageio.save_png(str(tmp_path / f"f{i}.png"), f)
    got = list(video.open_source(str(tmp_path), max_frames=2))
    assert len(got) == 2 and np.array_equal(got[1], ours[1])
    with pytest.raises(FileNotFoundError):
        video.open_source(str(tmp_path / "empty_dir_missing"))


# ---------------------------------------------------------------------------
# native feeder
# ---------------------------------------------------------------------------

def _write_pgm(path, img, comments=False):
    hdr = b"P5\n" + (b"# writer\n" if comments else b"")
    path.write_bytes(hdr + b"%d %d\n255\n" % (img.shape[1], img.shape[0])
                     + img.tobytes())


def test_feeder_synthetic_and_raw8(feeder, tmp_path):
    with feeder.FrameFeeder(64, 128, count=10, seed=42) as f:
        frames = [fr.copy() for fr in f]
        stats = f.stats()
    assert len(frames) == 10 and frames[0].dtype == np.uint8
    assert stats["produced"] == 10 and stats["read_errors"] == 0
    with feeder.FrameFeeder(64, 128, count=1, seed=42) as f:
        np.testing.assert_array_equal(next(iter(f)), frames[0])
    raw = np.random.default_rng(0).integers(0, 256, (5, 32, 64), np.uint8)
    (tmp_path / "s.y8").write_bytes(raw.tobytes() + bytes(100))
    with feeder.FrameFeeder(32, 64, mode=feeder.MODE_RAW8,
                            path=str(tmp_path / "s.y8")) as f:
        got = [fr.copy() for fr in f]
        assert f.stats()["read_errors"] == 1       # the partial frame
    np.testing.assert_array_equal(np.stack(got), raw)


def test_feeder_pgm_dir(feeder, tmp_path):
    frames = np.random.default_rng(1).integers(0, 256, (3, 16, 24), np.uint8)
    for i, fr in enumerate(frames):
        _write_pgm(tmp_path / f"frame_{i:06d}.pgm", fr, comments=i == 1)
    with feeder.FrameFeeder(16, 24, mode=feeder.MODE_PGM_DIR,
                            path=str(tmp_path)) as f:
        got = [fr.copy() for fr in f]
    np.testing.assert_array_equal(np.stack(got), frames)
    (tmp_path / "frame_000001.pgm").write_bytes(b"P5\n9 9\n255\n")
    with feeder.FrameFeeder(16, 24, mode=feeder.MODE_PGM_DIR,
                            path=str(tmp_path)) as f:
        assert len([1 for _ in f]) == 1
        assert f.stats()["read_errors"] == 1


def test_native_normalize_and_backpressure(feeder):
    img = np.random.default_rng(3).integers(-500, 1500, (33, 65)).astype(
        np.int16)
    np.testing.assert_array_equal(feeder.minmax_normalize_u8_native(img),
                                  imageio.minmax_normalize_u8(img))
    with feeder.FrameFeeder(16, 16, capacity=2, count=100) as f:
        assert sum(1 for _ in f) == 100
        assert f.stats()["produced"] == 100


def test_feeder_build_is_atomic_across_threads(feeder, tmp_path, monkeypatch):
    """Threads building into one build directory all load a whole library."""
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    errors = []

    def build():
        try:
            import ctypes

            ctypes.CDLL(str(runtime.build())).feeder_create
        except Exception as e:       # collected for the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        runtime.lib_path().name]


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def _runner(mn=30, mx=90, **kw):
    model = CannyTorch(1.0, device="cpu")
    return StreamingRunner(lambda b: model.batch(b, mn, mx), device="cpu",
                           **kw)


def test_stream_end_to_end_trims_padding():
    frames = list(video.frames_synthetic(40, 72, 7, seed=3))
    results = {}
    stats = _runner(batch_size=2).run(iter(frames),
                                      lambda bi, r: results.update({bi: r}))
    assert stats.batches == 4 and stats.frames == 7
    assert [results[i].shape[0] for i in range(4)] == [2, 2, 2, 1]
    got = np.concatenate([results[i] for i in range(4)])
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, golden.canny(f, 1.0, 30, 90))
    d = stats.to_dict()
    assert set(d) == {"frames", "batches", "seconds", "skipped_batches",
                      "fps", "mp_per_s"}


def test_cursor_is_atomic_and_resumes(tmp_path):
    cpath = str(tmp_path / "cursor.json")
    frames = list(video.frames_synthetic(24, 40, 8, seed=1))
    seen = []
    _runner(batch_size=2, cursor=StreamCursor(cpath)).run(
        iter(frames[:4]), lambda bi, r: seen.append(bi))
    assert seen == [0, 1] and json.load(open(cpath))["completed_batch"] == 1
    assert not os.path.exists(cpath + ".tmp")
    seen = []
    stats = _runner(batch_size=2, cursor=StreamCursor(cpath)).run(
        iter(frames), lambda bi, r: seen.append(bi))
    assert seen == [2, 3] and stats.skipped_batches == 2 and stats.frames == 4


def test_host_sharding_round_robin():
    frames = list(video.frames_synthetic(24, 40, 7, seed=2))
    per_host = {}
    for host in range(3):
        outs = []
        _runner(batch_size=2, host_id=host, num_hosts=3).run(
            iter(frames), lambda bi, r: outs.extend(r))
        per_host[host] = outs
    assert [len(v) for v in per_host.values()] == [3, 2, 2]
    for host, outs in per_host.items():
        for k, out in enumerate(outs):
            np.testing.assert_array_equal(
                out, golden.canny(frames[host + 3 * k], 1.0, 30, 90))


def test_prefetcher_error_reaches_consumer():
    def batches():
        yield np.zeros((1, 4, 4), np.uint8)
        raise OSError("disk went away")

    it = iter(DevicePrefetcher(batches(), lambda b: b, depth=2))
    assert next(it).shape == (1, 4, 4)
    with pytest.raises(OSError, match="disk went away"):
        next(it)
    with pytest.raises(ZeroDivisionError):      # through the runner too
        _runner(batch_size=1).run(
            (np.zeros((8, 8), np.uint8) if i < 2 else 1 / 0 for i in range(3)))


def test_runner_failure_leaves_resumable_cursor(tmp_path):
    cpath = str(tmp_path / "c.json")
    frames = list(video.frames_synthetic(24, 40, 6, seed=4))

    def on_result(bi, r):
        if bi == 1:
            raise RuntimeError("writer crashed")

    with pytest.raises(RuntimeError, match="writer crashed"):
        _runner(batch_size=2, cursor=StreamCursor(cpath)).run(iter(frames),
                                                              on_result)
    assert StreamCursor(cpath).completed == 0


# ---------------------------------------------------------------------------
# timing and trace
# ---------------------------------------------------------------------------

def test_profile_stages_slope_and_wall():
    img = np.random.default_rng(0).integers(0, 256, (32, 48), np.uint8)
    rep = timing.profile_stages(img, 1.0, 30, 90, device="cpu")
    assert [s.name for s in rep.stages] == ["gaussian", "sobel", "nms",
                                            "hysteresis"]
    assert rep.protocol == "slope" and rep.total_ms > 0
    j = rep.json()
    assert j["image_shape"] == [32, 48] and len(j["prefix_ms"]) == 4
    assert abs(rep.total_ms - j["prefix_ms"][-1]) < 1e-3
    assert "[slope]" in rep.table() and "TOTAL" in rep.table()
    wall = timing.profile_stages(img, 1.0, 30, 90, iters=2, protocol="wall",
                                 device="cpu")
    assert wall.protocol == "wall" and len(wall.stages) == 4
    assert abs(wall.total_ms - sum(s.ms for s in wall.stages)) < 1e-9


def test_slope_chain_lengths_and_throughput():
    k1, k2 = timing.auto_chain_lengths(1080 * 1920)
    assert 4 <= k1 < k2 <= 4000 and k1 == max(4, k2 // 20)
    assert timing.auto_chain_lengths(1) == (200, 4000)
    assert timing.auto_chain_lengths(10 ** 12) == (4, 40)
    img = np.random.default_rng(1).integers(0, 256, (16, 24), np.uint8)
    model = CannyTorch(1.0, device="cpu")
    secs = timing.checksum_slope_seconds(model, img, k1=2, k2=6, samples=2,
                                         return_samples=True, device="cpu")
    assert len(secs) == 2 and all(s > 0 for s in secs)
    assert timing.throughput_chained(model, img, k=3, repeats=2,
                                     device="cpu") > 0


def test_trace_writes_chrome_trace(tmp_path):
    from canny_edge_tpu_torch.utils.trace import annotate, trace

    with trace(str(tmp_path / "tr"), device="cpu") as out:
        with annotate("canny_region"):
            CannyTorch(1.0, device="cpu")(np.zeros((8, 8), np.uint8), 1, 2)
    path = os.path.join(out, "trace.json")
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "canny_region" in names


@pytest.mark.parametrize("call", ["runner", "profile", "trace"])
def test_entry_points_need_the_card_by_default(call, monkeypatch):
    from canny_edge_tpu_torch.utils.trace import trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if call == "runner":
            StreamingRunner(lambda b: b, batch_size=1)
        elif call == "profile":
            timing.profile_stages(np.zeros((8, 8), np.uint8), 1.0, 1, 2)
        else:
            with trace():
                pass


@pytest.mark.cuda
def test_stream_on_card_with_prefetch(cuda_device):
    """Batches staged on a side stream, read back on another: the card's
    stream equals the CPU's, frame for frame, at every prefetch depth."""
    frames = [imageio.synthetic_image(270, 480, seed=s) for s in range(9)]
    cpu = CannyTorch(1.4, device="cpu").batch(np.stack(frames), 30, 90)
    model = CannyTorch(1.4)
    for depth in (1, 4):
        got = {}
        StreamingRunner(lambda b: model.batch(b, 30, 90), batch_size=2,
                        prefetch_depth=depth).run(
            iter(frames), lambda bi, r: got.update({bi: r}))
        np.testing.assert_array_equal(
            np.concatenate([got[i] for i in range(5)]), cpu.numpy())
