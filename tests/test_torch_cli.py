"""PyTorch port, the command line (``canny_edge_tpu_torch.cli``) with
``--device cpu``: its PNGs, step images, ``--json`` keys and validation
messages against the JAX package's CLI (``canny_edge_tpu.cli``) on the same
inputs, bit for bit; the port's feeder inputs, resume, exit codes, and the
refusal of a sharded mesh that the devices cannot hold.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from canny_edge_tpu import golden
from canny_edge_tpu.cli import main as jax_main
from canny_edge_tpu_torch import cli, runtime
from canny_edge_tpu_torch.io import imageio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("smoothed", "magnitude", "nonmax")


def _run(argv, main=cli.main):
    """(exit code, stdout) of one in-process run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _png(path):
    return imageio.load_grayscale(str(path))


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, test_image):
    """The JAX CLI once on the test image: edges with -o, and -s."""
    d = tmp_path_factory.mktemp("jax")
    src = str(d / "in.png")
    imageio.save_png(src, test_image)
    rc = jax_main([src, "1.0", "50", "150", "-o", str(d / "edges.png"), "-s",
                   "--out-dir", str(d / "steps")])
    assert rc == 0
    return src, d


@pytest.mark.parametrize("backend,extra", [
    ("fused", []), ("pallas", []), ("xla", []), ("golden", []),
    ("fused", ["--packed-transfer"]), ("pallas", ["--packed-transfer"])])
def test_single_image_equals_jax_cli(backend, extra, jax_run, tmp_path):
    src, d = jax_run
    out = tmp_path / "edges.png"
    rc, text = _run([src, "1.0", "50", "150", "-o", str(out), "--out-dir",
                     str(tmp_path), "--backend", backend, "--device", "cpu",
                     *extra])
    assert rc == 0 and "Execution time:" in text
    np.testing.assert_array_equal(_png(out), _png(d / "edges.png"))


@pytest.mark.parametrize("backend", ["fused", "golden"])
def test_save_steps_equal_jax_cli(backend, jax_run, tmp_path):
    src, d = jax_run
    rc, _ = _run([src, "1.0", "50", "150", "-s", "-o", str(tmp_path / "e.png"),
                  "--out-dir", str(tmp_path / "steps"), "--backend", backend,
                  "--device", "cpu"])
    assert rc == 0
    for name in STEPS:
        np.testing.assert_array_equal(
            _png(tmp_path / "steps" / f"step_{name}.png"),
            _png(d / "steps" / f"step_{name}.png"))


@pytest.mark.parametrize("mode", ["component", "strict-reference"])
def test_stream_json_and_pngs_equal_jax_cli(mode, tmp_path):
    """A synthetic stream, batches of 2 (the last one padded)."""
    base = ["synthetic:24x40x5", "1.0", "30", "90", "--batch", "2",
            "--json", "--hysteresis", mode]
    rc, text = _run(base + ["--out-dir", str(tmp_path / "p"),
                            "--device", "cpu", "--prefetch", "3"])
    assert rc == 0
    ours = json.loads(text)
    rc, text = _run(base + ["--out-dir", str(tmp_path / "j"), "--backend",
                            "golden", "--prefetch", "3"], jax_main)
    theirs = json.loads(text)
    assert set(ours) == set(theirs) and set(ours["config"]) == set(
        theirs["config"])
    assert ours["frames"] == 5 and ours["batches"] == 3
    assert ours["config"]["prefetch_depth"] == 3
    assert ours["config"]["hysteresis_mode"] == mode
    assert _pngs(tmp_path / "p") == _pngs(tmp_path / "j") == [
        f"edges_{i:06d}.png" for i in range(5)]
    for name in _pngs(tmp_path / "p"):
        np.testing.assert_array_equal(_png(tmp_path / "p" / name),
                                      _png(tmp_path / "j" / name))


def test_golden_backend_is_the_stage_path(tmp_path):
    frames = [imageio.synthetic_image(24, 40, seed=i) for i in range(3)]
    rc, _ = _run(["synthetic:24x40x3", "1.4", "0", "40", "--backend",
                  "golden", "--hysteresis", "strict-reference", "--batch",
                  "2", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    for i, f in enumerate(frames):
        sm = golden.gaussian_blur(f, 1.4)
        ref = golden.hysteresis_strict(
            golden.nonmax_suppression(*golden.sobel(sm)), 0, 40)
        np.testing.assert_array_equal(
            _png(tmp_path / f"edges_{i:06d}.png").astype(np.int16), ref)


def test_resume_skips_completed_batches(tmp_path):
    out = str(tmp_path / "out")
    base = ["synthetic:24x32x12", "1.0", "40", "160", "--batch", "2",
            "--out-dir", out, "--resume", "--json", "--device", "cpu"]
    rc, text = _run(base[:1] + ["--max-frames", "6"] + base[1:])
    s1 = json.loads(text)
    assert rc == 0 and s1["frames"] == 6 and s1["skipped_batches"] == 0
    rc, text = _run(base)
    s2 = json.loads(text)
    assert rc == 0 and s2["skipped_batches"] == 3 and s2["frames"] == 6
    assert _pngs(out) == [f"edges_{i:06d}.png" for i in range(12)]
    for i in (0, 11):
        ref = golden.canny(imageio.synthetic_image(24, 32, seed=i), 1.0, 40,
                           160)
        np.testing.assert_array_equal(
            _png(os.path.join(out, f"edges_{i:06d}.png")).astype(np.int16),
            ref)


@pytest.mark.parametrize("argv,msg", [
    (["x.png", "1.0", "150", "50"], "minVal must be less than maxVal"),
    (["x.png", "1.0", "-1", "50"], "minVal must be in the range"),
    (["x.png", "1.0", "0", "256"], "maxVal must be in the range"),
    (["x.png", "-1.0", "0", "255"], "sigma must be positive"),
    (["synthetic:16x16", "1.0", "50", "150", "--packed-transfer",
      "--backend", "golden"], "packed-transfer"),
    (["synthetic:16x16", "1.0", "50", "150", "--packed-transfer",
      "--backend", "sharded"], "packed-transfer"),
    (["synthetic:16x16", "1.0", "50", "150", "--batch", "0"],
     "batch size must be >= 1"),
])
def test_validation_messages_equal_jax(argv, msg):
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jax_main(argv)
    assert msg in str(ours.value) and str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("extra", [["--mesh", "1x2x4"],
                                   ["--mesh", "2x1x1"]])
def test_multi_device_refused(extra):
    """A sharded mesh of another size than the process's one device is
    refused, as JAX's make_mesh refuses it."""
    with pytest.raises(SystemExit) as e:
        cli.main(["synthetic:16x16", "1.0", "50", "150", "--device", "cpu",
                  "--backend", "sharded", *extra])
    n = "x".join(extra[1].split("x"))
    assert str(e.value) == f"ERROR: mesh {n} != 1 devices"


def test_no_card_exits_with_the_model_message(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["synthetic:16x16", "1.0", "50", "150"])
    assert "CUDA is not available" in str(e.value)


def _needs_feeder():
    if not runtime.available():
        pytest.skip(f"native feeder unavailable: {runtime._state['error']}")


def _stage_ref(frame):
    sm = golden.gaussian_blur(frame, 1.0)
    return golden.hysteresis(golden.nonmax_suppression(*golden.sobel(sm)),
                             40, 160)


@pytest.mark.parametrize("source", ["raw8", "pgm_dir", "synthetic"])
def test_native_feeder_inputs(source, tmp_path):
    _needs_feeder()
    h, w, n = 16, 24, 5
    frames = np.random.default_rng(0).integers(0, 256, (n, h, w), np.uint8)
    if source == "raw8":
        frames.tofile(str(tmp_path / "f.raw"))
        spec = f"raw8:{tmp_path / 'f.raw'}:{h}x{w}x{n}"
    elif source == "pgm_dir":
        (tmp_path / "pgms").mkdir()
        for i, f in enumerate(frames):
            (tmp_path / "pgms" / f"frame_{i:06d}.pgm").write_bytes(
                b"P5\n%d %d\n255\n" % (w, h) + f.tobytes())
        spec = str(tmp_path / "pgms")
    else:
        with runtime.FrameFeeder(h, w, count=n) as feeder:
            frames = np.stack([f.copy() for f in feeder])
        spec = f"synthetic:{h}x{w}x{n}"
    out = tmp_path / "out"
    rc, text = _run([spec, "1.0", "40", "160", "--batch", "2",
                     "--native-feeder", "--out-dir", str(out), "--json",
                     "--device", "cpu"])
    stats = json.loads(text)
    assert rc == 0 and stats["frames"] == n
    assert stats["feeder"]["read_errors"] == 0
    assert stats["feeder"]["produced"] == n
    for i in (0, n - 1):
        np.testing.assert_array_equal(
            _png(out / f"edges_{i:06d}.png").astype(np.int16),
            _stage_ref(frames[i]))


@pytest.mark.parametrize("source", ["raw8", "pgm_dir"])
def test_corrupt_frame_exits_3(source, tmp_path, capsys):
    _needs_feeder()
    h, w = 16, 24
    frames = np.random.default_rng(1).integers(0, 256, (3, h, w), np.uint8)
    if source == "raw8":
        (tmp_path / "f.raw").write_bytes(frames.tobytes()[:-10])
        spec = f"raw8:{tmp_path / 'f.raw'}:{h}x{w}"
    else:
        (tmp_path / "p").mkdir()
        for i, f in enumerate(frames):
            body = f.tobytes() if i != 1 else b"garbage"
            (tmp_path / "p" / f"frame_{i:06d}.pgm").write_bytes(
                b"P5\n%d %d\n255\n" % (w, h) + body)
        spec = str(tmp_path / "p")
    rc = cli.main([spec, "1.0", "40", "160", "--native-feeder", "--json",
                   "--out-dir", str(tmp_path / "o"), "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 3 and "ended early" in captured.err
    stats = json.loads(captured.out)
    assert stats["feeder"]["read_errors"] == 1
    assert stats["frames"] == (2 if source == "raw8" else 1)


def test_time_prints_the_stage_table(tmp_path, capsys):
    rc = cli.main(["synthetic:24x32x1", "1.0", "30", "90", "--time",
                   "--json", "--out-dir", str(tmp_path), "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0 and "[slope]" in captured.err
    stages = json.loads(captured.out)["stages"]
    assert [s["name"] for s in stages["stages"]] == [
        "gaussian", "sobel", "nms", "hysteresis"]
    assert stages["image_shape"] == [24, 32]


def test_python_dash_m_entry_point(tmp_path, test_image):
    """``python -m canny_edge_tpu_torch.cli`` runs as an executable."""
    src = str(tmp_path / "in.png")
    imageio.save_png(src, test_image)
    r = subprocess.run(
        [sys.executable, "-m", "canny_edge_tpu_torch.cli", src, "1.0", "50",
         "150", "-o", str(tmp_path / "out.png"), "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Execution time:" in r.stdout
    np.testing.assert_array_equal(
        _png(tmp_path / "out.png").astype(np.int16),
        golden.canny(test_image, 1.0, 50, 150))


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cli_on_card_equals_cpu(cuda_device, tmp_path):
    for dev, extra in (("cuda", []), ("cuda", ["--packed-transfer"]),
                       ("cpu", [])):
        rc, _ = _run(["synthetic:120x200x5", "1.4", "30", "90", "--batch",
                      "2", "--out-dir", str(tmp_path / (dev + str(extra))),
                      "--device", dev, *extra])
        assert rc == 0
    for name in _pngs(tmp_path / "cpu[]"):
        ref = _png(tmp_path / "cpu[]" / name)
        for d in ("cuda[]", "cuda['--packed-transfer']"):
            np.testing.assert_array_equal(_png(tmp_path / d / name), ref)
