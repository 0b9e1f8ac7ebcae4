"""PyTorch port, the seeded sweep: ``chip_smoke.sweep_configs`` (the
configurations of ``chip_smoke.py`` phase 14) and the port's plain
pipeline and kernel mirrors on them.

* The generator is deterministic, draws what it promises (sizes near the
  kernels' edges, the forced thresholds, both modes, batches, the extra
  NMS maps) and appends the JAX package's fuzz configurations
  (``tests/test_fuzz_bitexact.py``, ``tests/test_fuzz_sharded.py``, read
  from those files) with all ten mesh factorizations.
* Twelve frame configurations drawn at ``max_hw=(160, 240)`` run the
  port's plain pipeline on the CPU (``CannyTorch`` with each backend and
  ``canny_fused`` with each engine, a batch as one call) and the tile
  mirrors of K2 (``ops/packed_tiles.py``), K3 (``ops/dilate_tiles.py``)
  and K4 (``ops/banded_skip.py``), each held against the NumPy oracle
  ``canny_edge_tpu.golden`` (no JAX compiles).  K2's mirror with the strict
  fix at the configuration's random (row, word), which no oracle defines
  off (0, 0), is held against the port's plain flood with the same fix on
  masks where ``chip_smoke.plant_quirk`` planted the case the fix decides.
  Two configurations also run JAX's jitted ``canny_fn(backend="fused")``,
  whose Pallas kernels run in interpret mode.
* On the card: phase 14's kernel modes on the first eight frame
  configurations at full size, and K1 on a batch of 65537 frames.

Tolerance: 0 differing pixels.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from canny_edge_tpu_torch import CannyTorch  # noqa: E402
from canny_edge_tpu_torch.kernels.fused import IMPLS, canny_fused  # noqa: E402
from canny_edge_tpu_torch.ops import packed as P  # noqa: E402
from canny_edge_tpu_torch.ops.banded_skip import \
    hysteresis_banded_skip  # noqa: E402
from canny_edge_tpu_torch.ops.dilate_tiles import \
    hysteresis_dilate_tiles  # noqa: E402
from canny_edge_tpu_torch.ops.packed_tiles import \
    hysteresis_packed_tiles  # noqa: E402

SMALL = chip_smoke.sweep_configs(n=12, max_hw=(160, 240))["frames"][:12]
# the two smallest frames two words wide or more also run JAX's pipeline
# (its Pallas kernels in interpret mode)
JAX_CASES = sorted((i for i in range(12) if SMALL[i]["w"] > 32),
                   key=lambda i: SMALL[i]["h"] * SMALL[i]["w"])[:2]


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _jax_test_module(name):
    """One of the JAX package's fuzz test files, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden(img, cfg, nm=None, lo=None, hi=None):
    """The oracle's edges of a frame (or of an NMS map at ``lo``/``hi``)
    in the configuration's mode."""
    if nm is None:
        nm = golden.nonmax_suppression(*golden.sobel(
            golden.gaussian_blur(img, cfg["sigma"])))
        lo, hi = cfg["mn"], cfg["mx"]
    hyst = golden.hysteresis_strict if cfg["strict"] else golden.hysteresis
    return hyst(nm, lo, hi)


def test_generator_is_reproducible():
    a = chip_smoke.sweep_configs()
    assert a == chip_smoke.sweep_configs()
    assert a != chip_smoke.sweep_configs(seed=chip_smoke.SWEEP_SEED + 1)
    assert a["sharded"] == chip_smoke.sweep_configs(n=3)["sharded"]
    for cfg in a["frames"][:4]:
        np.testing.assert_array_equal(chip_smoke.sweep_images(cfg),
                                      chip_smoke.sweep_images(dict(cfg)))


def test_generator_covers_the_geometry():
    cfgs = chip_smoke.sweep_configs()
    drawn = cfgs["frames"][:24]
    assert len(cfgs["frames"]) == 24 + 10 + 6 and len(cfgs["sharded"]) == 13
    assert all(1 <= c["h"] <= 1200 and 1 <= c["w"] <= 2100 for c in drawn)
    near = [c for c in drawn if any(abs(c["w"] - k * 32) <= 2
                                    for k in range(1, 2100 // 32 + 2))]
    assert len(near) >= 6, [c["w"] for c in drawn]
    assert any(c["w"] % 32 not in (0, 1, 31) for c in near)   # ragged too
    assert {(c["mn"], c["mx"]) for c in drawn} >= {(0, 1), (0, 255),
                                                   (254, 255)}
    assert all(0 <= c["mn"] < c["mx"] <= 255 for c in drawn)
    assert {c["strict"] for c in drawn} == {False, True}
    assert {c["batch"] for c in drawn} == {1, 2, 3, 5}
    assert {c["nm"] for c in drawn} == {None, "random", "snake", "sparse"}
    assert {c["sigma"] for c in drawn} <= set(chip_smoke.SWEEP_SIGMAS)
    assert len({c["sigma"] for c in drawn}) >= 7
    for c in cfgs["frames"]:
        r, wd = c["quirk_rw"]
        assert 0 <= r < c["h"] and 0 <= wd < -(-c["w"] // 32)
        nm = chip_smoke.sweep_nm(c)
        assert nm is None or nm.shape == (c["h"], c["w"])
    assert {c["mesh"] for c in cfgs["sharded"]} == set(chip_smoke.MESHES)


def test_generator_appends_jax_fuzz():
    cfgs = chip_smoke.sweep_configs()
    fuzz = _jax_test_module("test_fuzz_bitexact")
    got = [(c["h"], c["w"], c["sigma"], c["mn"], c["mx"])
           for c in cfgs["frames"][24:34]]
    assert got == [tuple(c[1:]) for c in fuzz._configs()]
    for c in cfgs["frames"][24:34]:      # JAX's frame of that configuration
        rng = np.random.default_rng(c["img_seed"])
        np.testing.assert_array_equal(
            chip_smoke.sweep_images(c)[0],
            rng.integers(0, 256, (c["h"], c["w"]), np.uint8))
    shapes = [(c["h"], c["w"]) for c in cfgs["frames"][34:]]
    assert shapes == [(1, 50), (50, 1), (1, 1), (2, 2), (3, 200), (200, 3)]
    sharded = _jax_test_module("test_fuzz_sharded")
    assert [(c["h"], c["w"], c["sigma"], c["mn"], c["mx"], *c["mesh"])
            for c in cfgs["sharded"]] \
        == [tuple(c[1:]) for c in sharded._configs()]


@pytest.mark.parametrize("i", range(12))
def test_plain_pipeline_and_mirrors_equal_golden(i):
    cfg = SMALL[i]
    imgs = chip_smoke.sweep_images(cfg)
    b, h, w = imgs.shape
    mode = "strict-reference" if cfg["strict"] else "component"
    mn, mx = cfg["mn"], cfg["mx"]
    want = np.stack([_golden(f, cfg) for f in imgs])
    for backend in ("fused", "pallas", "xla"):
        model = CannyTorch(cfg["sigma"], hysteresis_mode=mode,
                           backend=backend, device="cpu")
        got = model.batch(imgs, mn, mx) if b > 1 else model(imgs[0], mn, mx)
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want,
                                      err_msg=f"{backend} {cfg}")
    t = torch.from_numpy(imgs)
    for impl in IMPLS if not cfg["strict"] else ("packed", "packed-xla"):
        got = canny_fused(t, mn, mx, kernel_vals=model.taps,
                          hysteresis_impl=impl, strict=cfg["strict"])
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"canny_fused {impl} {cfg}")
    # the mirrors on each frame's map (the oracle's) and the extra map
    maps = [(golden.nonmax_suppression(*golden.sobel(golden.gaussian_blur(
        f, cfg["sigma"]))), mn, mx) for f in imgs]
    extra = chip_smoke.sweep_nm(cfg)
    if extra is not None:
        maps.append((extra, *chip_smoke.ENGINE_THRESHOLDS[cfg["nm"]]))
    for nm, lo, hi in maps:
        ref = _golden(None, cfg, nm, lo, hi)
        t = torch.from_numpy(nm.astype(np.int32))
        weak, strong = P.pack_mask(t >= lo), P.pack_mask(t >= hi)
        edges, _, _ = hysteresis_packed_tiles(weak, strong, h, w,
                                              strict=cfg["strict"])
        np.testing.assert_array_equal(P.unpack_edges(edges, w).numpy(), ref,
                                      err_msg=f"K2 mirror {cfg}")
        q = tuple(cfg["quirk_rw"])
        weak, strong = (P.pack_mask(x) for x in chip_smoke.plant_quirk(
            t >= lo, t >= hi, q))
        edges, _, _ = hysteresis_packed_tiles(weak, strong, h, w,
                                              strict=True, quirk_rw=q)
        plain, _ = P.hysteresis_packed_masks(weak, strong, h, w, strict=True,
                                             quirk_rw=q)
        assert torch.equal(edges.view(torch.int32), plain.view(torch.int32))
        if h >= 2 and w >= 3:     # the planted case: an edge only without
            comp, _ = P.hysteresis_packed_masks(weak, strong, h, w)
            at = (q[0], 32 * q[1] + 1)
            assert P.unpack_mask(comp, w)[at] and \
                not P.unpack_mask(plain, w)[at]
        comp = golden.hysteresis(nm, lo, hi)
        for mirror in (hysteresis_dilate_tiles, hysteresis_banded_skip):
            got, _, _ = mirror(t, lo, hi)
            np.testing.assert_array_equal(got.numpy(), comp,
                                          err_msg=f"{mirror.__name__} {cfg}")


@pytest.mark.parametrize("i", JAX_CASES)
def test_jax_fused_pipeline_agrees(i):
    """JAX's jitted fused pipeline (its Pallas kernels in interpret mode)
    on the configuration's first frame equals the port's and the oracle."""
    import jax

    from canny_edge_tpu.models.canny import canny_fn as jax_canny_fn

    cfg = SMALL[i]
    img = chip_smoke.sweep_images(cfg)[0]
    mode = "strict-reference" if cfg["strict"] else "component"
    kv = tuple(float(v) for v in golden.gaussian_kernel(cfg["sigma"]))
    want = np.asarray(jax.jit(lambda x: jax_canny_fn(
        x, cfg["mn"], cfg["mx"], kernel_vals=kv, backend="fused",
        hysteresis_mode=mode))(img))
    got = CannyTorch(cfg["sigma"], hysteresis_mode=mode, device="cpu")(
        img, cfg["mn"], cfg["mx"])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _golden(img, cfg))


@pytest.mark.cuda
def test_card_sweep_first_configurations(cuda_device):
    """Phase 14's kernel modes (K1 NMS, threshold and batch; K2's modes and
    quirk against the plain flood and its mirror; K3 and K4 against their
    plain versions; the entry points against the CPU and the oracle) on
    the first eight frame configurations at full size."""
    cfgs = chip_smoke.sweep_configs()
    rep = chip_smoke.sweep_phase(cuda_device, {
        "frames": cfgs["frames"][:8], "sharded": []}, workers=4,
        chunked=None)
    assert rep["mismatches"] == 0
    for case in ("k1_nm", "k1_threshold", "k1_batch_nm", "k2_quirk",
                 "k2_masks_packed_strict", "k2_nm_int16_component",
                 "k3_plain", "k4_plain", "golden", "cpu_pallas"):
        assert rep["cases"].get(case), case


@pytest.mark.cuda
def test_card_k1_batch_beyond_one_launch(cuda_device):
    """65537 frames of 1x3: two K1 launches (65535 + 2 frames), every
    frame equal to the plain version's."""
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.ops import window as Wn

    kern = golden.gaussian_kernel(1.4)
    taps = torch.from_numpy(kern).to(cuda_device)
    distinct = np.random.default_rng(9).integers(0, 256, (251, 1, 3),
                                                 np.uint8)
    pick = np.arange(65537) % 251
    imgs = torch.from_numpy(distinct[pick]).to(cuda_device)
    before = (kfe.launches, kfe.batch_launches)
    nm = kfe.frontend(imgs, taps)
    weak, strong = kfe.frontend(imgs, taps, (10, 40))
    torch.cuda.synchronize()
    assert (kfe.launches - before[0], kfe.batch_launches - before[1]) == (4, 4)
    ref = torch.stack([Wn.frontend_nm(f, kern) for f in
                       torch.from_numpy(distinct).to(cuda_device)])
    assert nm.shape == (65537, 1, 3)
    assert torch.equal(nm, ref.to(torch.int16)[pick])
    assert torch.equal(weak.view(torch.int32),
                       P.pack_mask(ref >= 10).view(torch.int32)[pick])
    assert torch.equal(strong.view(torch.int32),
                       P.pack_mask(ref >= 40).view(torch.int32)[pick])
