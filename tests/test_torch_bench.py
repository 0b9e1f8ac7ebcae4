"""PyTorch port, the modules of the seventh slice: the functional entry
points (``models.canny_fn``, ``canny_fn_packed``, ``canny_fn_batched``,
``sobel_fn``, ``sobel_magnitude_fn``) and ``golden`` against the JAX
package's (JAX on the CPU, its Pallas kernels in interpret mode; the NumPy
oracle); ``utils/constants.py`` against the CUDA sources; ``utils/opcount.py``,
``utils/roofline.py`` and ``bench_torch.py``.  Tolerance: none (bit-equal
results, exact counts and bounds) unless a test states one.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden as jgolden
from canny_edge_tpu.io.imageio import synthetic_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_torch  # noqa: E402
from canny_edge_tpu_torch import golden  # noqa: E402
from canny_edge_tpu_torch import models  # noqa: E402
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel  # noqa: E402
from canny_edge_tpu_torch.utils import (constants, opcount,  # noqa: E402
                                        roofline)

CSRC = os.path.join(ROOT, "canny_edge_tpu_torch", "kernels", "csrc")
H100 = "NVIDIA H100 80GB HBM3"
SIGMA, MN, MX = 1.4, 30, 90
KV = tuple(float(v) for v in jgolden.gaussian_kernel(SIGMA))


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _frame(seed=3):
    """A small non-square frame."""
    return synthetic_image(57, 83, seed=seed)


def _eq(ours, theirs):
    theirs = np.asarray(theirs)
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------------------------
# the functional entry points against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,mode", [
    ("xla", "component"), ("fused", "component"), ("pallas", "component"),
    ("fused", "strict-reference")])
def test_canny_fn_equals_jax(backend, mode):
    from canny_edge_tpu.models.canny import canny_fn

    img = _frame()
    img[1, 0] = 255                       # beside the strict mode's quirk
    got = models.canny_fn(img, MN, MX, kernel_vals=KV, backend=backend,
                          hysteresis_mode=mode, device="cpu")
    _eq(got, canny_fn(img, MN, MX, kernel_vals=KV, backend=backend,
                      hysteresis_mode=mode))


def test_canny_fn_packed_equals_jax():
    from canny_edge_tpu.models.canny import canny_fn_packed

    img = _frame()
    got = models.canny_fn_packed(torch.from_numpy(img), MN, MX,
                                 kernel_vals=KV)
    assert got.dtype == torch.uint32 and got.shape == (57, 3)
    _eq(got.view(torch.int32),
        np.asarray(canny_fn_packed(img, MN, MX, kernel_vals=KV)).view(
            np.int32))


def test_canny_fn_batched_equals_jax():
    from canny_edge_tpu.models.canny import canny_fn_batched

    imgs = np.stack([_frame(3), _frame(4)])
    got = models.canny_fn_batched(imgs, MN, MX, kernel_vals=KV, device="cpu")
    assert got.shape == (2, 57, 83)
    _eq(got, canny_fn_batched(imgs, MN, MX, kernel_vals=KV))


def test_sobel_fns_equal_jax():
    from canny_edge_tpu.models.sobel import sobel_fn, sobel_magnitude_fn

    img = _frame()
    _eq(models.sobel_fn(img, 80, kernel_vals=KV, device="cpu"),
        sobel_fn(img, 80, kernel_vals=KV))
    _eq(models.sobel_magnitude_fn(torch.from_numpy(img), kernel_vals=KV),
        sobel_magnitude_fn(img, kernel_vals=KV))


def test_entry_points_run_where_the_input_lies(monkeypatch):
    """A tensor runs where it lies; a NumPy frame goes to the card by
    default and raises without one; an unknown backend or mode raises."""
    img = _frame()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: models.canny_fn(img, MN, MX, kernel_vals=KV),
               lambda: models.canny_fn_packed(img, MN, MX, kernel_vals=KV),
               lambda: models.sobel_fn(img, 80, kernel_vals=KV)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    out = models.canny_fn(torch.from_numpy(img), MN, MX, kernel_vals=KV,
                          backend="fused")
    assert out.device.type == "cpu" and out.dtype == torch.int16
    with pytest.raises(ValueError, match="unknown backend"):
        models.canny_fn(img, MN, MX, kernel_vals=KV, backend="tpu",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown hysteresis mode"):
        models.canny_fn_packed(img, MN, MX, kernel_vals=KV,
                               hysteresis_mode="bfs", device="cpu")


# ---------------------------------------------------------------------------
# the port's golden against the JAX package's
# ---------------------------------------------------------------------------

def test_golden_canny_equals_jax_golden():
    img = _frame()
    for mn, mx in ((MN, MX), (0, 40)):
        out, inter = golden.canny(img, SIGMA, mn, mx, intermediates=True)
        ref, ref_inter = jgolden.canny(img, SIGMA, mn, mx, intermediates=True)
        _eq(out, ref)
        for k in ("smoothed", "magnitude", "angle", "nonmax"):
            _eq(inter[k], ref_inter[k])


@pytest.mark.parametrize("name", ["hysteresis_bfs", "hysteresis_strict",
                                  "hysteresis"])
def test_golden_hysteresis_equals_jax_golden(name):
    nm = jgolden.nonmax_suppression(*jgolden.sobel(
        jgolden.gaussian_blur(_frame(), 1.0)))
    nm[1, 0], nm[0, 1] = 200, 35          # the BFS's bounds quirk
    for mn, mx in ((MN, MX), (20, 60)):
        _eq(getattr(golden, name)(nm, mn, mx),
            getattr(jgolden, name)(nm, mn, mx))


def test_golden_quantize_angle_cpp_float_equals_jax_golden():
    rng = np.random.default_rng(5)
    gx = rng.integers(-1443, 1444, (64, 64)).astype(np.int16)
    gy = rng.integers(-1443, 1444, (64, 64)).astype(np.int16)
    gx[0, :3], gy[0, :3] = 0, [0, 7, -7]
    _eq(golden.quantize_angle_cpp_float(gx, gy),
        jgolden.quantize_angle_cpp_float(gx, gy))
    _eq(golden.quantize_angle(gx, gy), jgolden.quantize_angle(gx, gy))


@pytest.mark.parametrize("sigma", [0.3, 0.5, 1.0, 1.4, 2.0, 3.0, 6.0, 9.0])
def test_gaussian_taps_equal_golden(sigma):
    """``ops/gaussian.py`` keeps its taps; they equal the oracle's, bit for
    bit, and the JAX package's."""
    got = gaussian_kernel(sigma)
    for ref in (golden.gaussian_kernel(sigma), jgolden.gaussian_kernel(sigma)):
        assert got.dtype == ref.dtype == np.float32
        _eq(got.view(np.int32), ref.view(np.int32))


# ---------------------------------------------------------------------------
# utils/constants.py
# ---------------------------------------------------------------------------

def _constexpr(path, name):
    text = open(os.path.join(CSRC, path)).read()
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    assert m, f"{name} not in {path}"
    return int(m.group(1))


def test_constants_mirror_the_cuda_constexprs():
    assert constants.K1_TILE == (_constexpr("frontend.cu", "TILE_H"),
                                 _constexpr("frontend.cu", "TILE_W"))
    assert constants.K2_TILE == (_constexpr("masks.cuh", "TILE_ROWS"),
                                 _constexpr("hysteresis_packed.cu",
                                            "TILE_WORDS"))
    # K3's default tile has no constexpr: its window, cut into K2_TILE
    # sub-tiles, must fit the block's warps, one sub-tile a warp
    th, tw = constants.K3_TILE
    rows, words = constants.K2_TILE
    window_words = -(-(tw + 2) // 32)
    subtiles = -(-(th + 2) // rows) * -(-window_words // words)
    assert subtiles == 17
    assert subtiles <= _constexpr("hysteresis_dilate.cu", "THREADS") // 32


def test_constants_are_the_modules_knobs():
    import inspect

    from canny_edge_tpu.utils import constants as jconstants
    from canny_edge_tpu_torch.ops import dilate, packed, packed_tiles
    from canny_edge_tpu_torch.parallel import sharded

    assert constants.INNER_DILATE_XLA == jconstants.INNER_DILATE_XLA
    assert sharded.INNER_DILATE_XLA is constants.INNER_DILATE_XLA
    default = inspect.signature(packed.hysteresis_packed_masks).parameters[
        "inner_dilate"].default
    assert default == constants.INNER_DILATE_XLA
    assert packed_tiles.DEFAULT_TILE is constants.K2_TILE
    assert dilate.DEFAULT_TILE is constants.K3_TILE


def test_geometry_needs_a_card(monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        constants.sm_count("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (constants.sm_count, constants.smem_optin_bytes,
               constants.l2_bytes, constants.geometry):
        with pytest.raises(RuntimeError, match="no card"):
            fn("cuda")


@pytest.mark.cuda
def test_card_geometry(cuda_device):
    g = constants.geometry(cuda_device)
    assert g["sm_count"] > 0 and g["l2_bytes"] > 0
    assert g["smem_optin_bytes"] >= 48 * 1024


# ---------------------------------------------------------------------------
# utils/opcount.py
# ---------------------------------------------------------------------------

def test_opcount_audit_buckets():
    x = torch.zeros(8, 128)
    rep = opcount.audit_compiled(lambda t: torch.clamp_min(t * 2 + 1, 0), x,
                                 pixels=8 * 128)
    assert rep["buckets"]["alu"] == 3
    assert rep["buckets"].get("movement", 0) <= 1
    assert rep["materialized_bytes_per_px"] == 12 and rep["operations"] == 3


def test_opcount_names_and_views():
    """In-place and operator forms are normalised before bucketing, and
    views count as nothing."""
    x = torch.arange(64, dtype=torch.int64).reshape(8, 8)

    def f(t):
        y = t << 2                       # __lshift__
        y &= 7                           # bitwise_and_
        z = y[:, 1:].unsqueeze(0).expand(2, 8, 7).permute(0, 2, 1)
        return z.to(torch.int32), y.sum(-1)

    rep = opcount.audit_compiled(f, x, pixels=64)
    assert rep["buckets"] == {"alu": 2.0, "convert": 1.75, "reduce": 0.12}
    assert set(rep["top_ops"]) == {"lshift", "bitwise_and", "to_copy", "sum"}


def test_opcount_front_end_per_pixel():
    """The plain front end's buckets a pixel agree within 10% at two sizes
    (the halo's share shrinks with the frame) and hold no view."""
    from canny_edge_tpu_torch.ops.window import frontend_nm

    reps = []
    for h, w in ((64, 96), (128, 192)):
        img = torch.from_numpy(bench_torch.make_image(h, w))
        reps.append(opcount.audit_compiled(frontend_nm, img, gaussian_kernel(
            SIGMA), (MN, MX), pixels=h * w))
    a, b = (r["buckets"] for r in reps)
    assert set(a) == set(b) and a["alu"] > 50
    for k in ("alu", "convert", "movement"):
        assert abs(a[k] - b[k]) <= 0.1 * b[k], (k, a, b)
    for r in reps:
        assert not set(r["top_ops"]) & opcount.SKIP


# ---------------------------------------------------------------------------
# utils/roofline.py
# ---------------------------------------------------------------------------

def test_roofline_report():
    rep = roofline.report(2_073_600, {"frontend": 1e-3, "hysteresis": 5e-4},
                          H100)
    assert "3350" in rep and "frontend" in rep and "33.50" in rep
    assert roofline.chip_bandwidth_gbps(H100) == 3350.0
    assert roofline.chip_ops_per_s(H100) == 33.5e12
    assert roofline.chip_bandwidth_gbps("NVIDIA H100 PCIe") is None
    assert "unknown card" in roofline.report(1, {"frontend": 1e-3}, "x")
    st = roofline.StageTraffic("x", 10.0, 100.0)
    assert np.isclose(st.mem_seconds(1e6, 1000.0), 1e-5)
    assert np.isclose(st.compute_seconds(1e6, 1e12), 1e-4)


@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
def test_roofline_stage_rows(backend):
    rows = roofline.stage_rooflines(
        2_073_600, {"frontend": 1e-3, "hysteresis": 5e-4}, H100,
        backend=backend)
    assert {r["stage"] for r in rows} == {"frontend", "hysteresis"}
    for r in rows:
        assert 0 < r["pct_of_sol"] <= 100
        assert r["sol_ms"] < r["ms"] * 1.001
        assert r["bound"] in ("alu", "hbm")
        assert r["sol_ms"] == max(r["mem_sol_ms"], r["compute_sol_ms"])
        assert r["floor_model"] == "hand_modeled_alu" and r["audit"] is None
    fe, hy = rows
    assert fe["est_ops_per_px"] == 89
    assert (fe["min_hbm_bytes_per_px"], hy["min_hbm_bytes_per_px"]) == {
        "fused": (1.25, 2.25), "pallas": (3, 4), "xla": (5, 6)}[backend]


def test_roofline_audited_override():
    audited = {"frontend": {"buckets": {"alu": 117.0, "movement": 4.0}}}
    (row,) = roofline.stage_rooflines(1_000_000, {"frontend": 1e-3}, H100,
                                      backend="fused", audited_ops=audited)
    assert row["floor_model"] == "audit_alu"
    assert row["audit"] == {"alu": 117.0, "movement": 4.0}
    assert row["est_ops_per_px"] == 89
    expect_ms = 117.0 * 1_000_000 / 33.5e12 * 1e3
    assert row["compute_sol_ms"] == round(expect_ms, 6)
    # without the audit the hand model is used and no audit is attached
    (row2,) = roofline.stage_rooflines(1_000_000, {"frontend": 1e-3}, H100,
                                       backend="fused")
    assert row2["audit"] is None and row2["floor_model"] == "hand_modeled_alu"
    assert row2["compute_sol_ms"] == round(89 * 1e6 / 33.5e12 * 1e3, 6)
    # a card not in the table: no floors, and said so
    (row3,) = roofline.stage_rooflines(1_000_000, {"frontend": 1e-3},
                                       "NVIDIA H100 PCIe", backend="fused",
                                       audited_ops=audited)
    assert row3["bound"] == "unknown card"
    assert row3["sol_ms"] is row3["pct_of_sol"] is row3["mem_sol_ms"] is None
    assert row3["audit"] == audited["frontend"]["buckets"]


# the bounds of chip_smoke.py's `kernels` line as it computed them before
# they moved to kernel_bounds (its report on NVIDIA H100 80GB HBM3, 700.00 W)
KERNELS_LINE_BOUNDS = {
    "frontend": (0.005508967164179104, "operations"),
    "hysteresis_packed": (0.00023211940298507465, "bytes"),
    "hysteresis_dilate": (0.0024759402985074625, "bytes"),
    "hysteresis_banded": (0.0024759402985074625, "bytes"),
    "frontend_block": (0.002754483582089552, "operations"),
    "hysteresis_packed_quirk": (0.00012402626865671643, "bytes"),
}


def test_kernel_bounds_are_the_kernels_line():
    kb = roofline.kernel_bounds()
    for name, (ms, by) in KERNELS_LINE_BOUNDS.items():
        assert (kb[name]["bound_ms"], kb[name]["bound_by"]) == (ms, by), name
    nm = kb["hysteresis_packed_nm_int16"]
    assert nm["bound_by"] == "bytes"
    assert nm["bound_ms"] == 4 * 1080 * 1920 / 3.35e12 * 1e3


# ---------------------------------------------------------------------------
# bench_torch.py
# ---------------------------------------------------------------------------

def test_make_image_is_bench_py_s():
    for hw, seed in (((1080, 1920), 0), ((57, 83), 4)):
        np.testing.assert_array_equal(bench_torch.make_image(*hw, seed=seed),
                                      bench.make_image(*hw, seed=seed))


def test_bench_hysteresis_audit_composition():
    img = torch.from_numpy(bench_torch.make_image(128, 256))
    kern = gaussian_kernel(SIGMA)
    aud = bench_torch.audit_hysteresis(img, kern, from_nm=False)
    assert aud["rounds"] >= 2
    assert aud["buckets"]["alu"] > 1.0
    assert aud["buckets"]["movement"] > 0.5
    assert aud["composition"].startswith("rounds*")
    nm_aud = bench_torch.audit_hysteresis(img, kern, from_nm=True)
    assert nm_aud["rounds"] == aud["rounds"]
    assert nm_aud["buckets"]["alu"] > aud["buckets"]["alu"]
    (row,) = roofline.stage_rooflines(128 * 256, {"hysteresis": 1e-5}, H100,
                                      backend="fused",
                                      audited_ops={"hysteresis": aud})
    assert row["floor_model"] == "audit_alu" and row["sol_ms"] > 0


def test_bench_exits_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_torch.main()
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.measure()


def test_new_modules_load_no_jax():
    code = ("import sys; before = set(sys.modules); "
            "import canny_edge_tpu_torch.golden, "
            "canny_edge_tpu_torch.models, "
            "canny_edge_tpu_torch.utils.constants, "
            "canny_edge_tpu_torch.utils.opcount, "
            "canny_edge_tpu_torch.utils.roofline, bench_torch; "
            "bad = [m for m in set(sys.modules) - before if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'canny_edge_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_golden_backend_runs_golden(tmp_path, monkeypatch):
    """``--backend golden`` runs the port's NumPy oracle, where the JAX CLI
    runs its own."""
    from canny_edge_tpu_torch import cli
    from canny_edge_tpu_torch.io.imageio import load_grayscale

    calls = []
    blur = golden.gaussian_blur
    monkeypatch.setattr(golden, "gaussian_blur",
                        lambda f, s: calls.append(f.shape) or blur(f, s))
    rc = cli.main(["synthetic:24x40x2", "1.4", str(MN), str(MX), "--backend",
                   "golden", "--json", "--out-dir", str(tmp_path)])
    assert rc == 0 and calls == [(24, 40)] * 2
    got = load_grayscale(os.path.join(tmp_path, "edges_000001.png"))
    _eq(got, jgolden.canny(synthetic_image(24, 40, seed=1), 1.4, MN,
                           MX).astype(np.uint8))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "pallas", "xla"])
def test_card_canny_fn_equals_cpu(cuda_device, backend):
    img = bench_torch.make_image(270, 480, seed=2)
    got = models.canny_fn(img, MN, MX, kernel_vals=KV, backend=backend)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), models.canny_fn(
        img, MN, MX, kernel_vals=KV, backend=backend, device="cpu"))
    packed = models.canny_fn_packed(img, MN, MX, kernel_vals=KV)
    assert torch.equal(packed.cpu().view(torch.int32), models.canny_fn_packed(
        img, MN, MX, kernel_vals=KV, device="cpu").view(torch.int32))


@pytest.mark.cuda
def test_card_opcount_equals_cpu(cuda_device):
    """The audit counts the plain version's work wherever it runs."""
    from canny_edge_tpu_torch.ops.window import frontend_nm

    img = torch.from_numpy(bench_torch.make_image(64, 96))
    kern = gaussian_kernel(SIGMA)
    cpu, card = (opcount.audit_compiled(frontend_nm, img.to(d), kern,
                                        (MN, MX), pixels=64 * 96)
                 for d in ("cpu", cuda_device))
    assert card["buckets"]["alu"] == cpu["buckets"]["alu"]


@pytest.mark.cuda
def test_card_bench_record(cuda_device):
    rec = bench_torch.measure(samples=1, hw=(270, 480))
    assert set(rec["backends"]) == set(bench_torch.BACKENDS)
    assert all(v["mp_per_s"] > 0 for v in rec["backends"].values())
    assert {r["stage"] for r in rec["roofline"]} == {"frontend", "hysteresis"}
    json.dumps(rec)
