"""PyTorch port, the multi-device path on the CPU: ``parallel.ShardedCanny``
over in-process meshes of 8 blocks (``torch.device("cpu")`` repeated 8
times, the counterpart of the JAX tests' 8 fake CPU devices).

Bit-equal (the tolerance everywhere) to the golden model, as the JAX
package's own tests check it (the counterparts of ``tests/test_sharded.py``,
``tests/test_fuzz_sharded.py`` and the sharded cases of
``tests/test_strict_mode.py``), and to JAX's ``ShardedCanny`` on the same
mesh and inputs in a static, a generic, a strict and a data-parallel case.
The pieces: the halo exchange against JAX's under ``jax.shard_map``; the
plain block front end against JAX's ``window_nm`` / ``frontend_nm_static``
at each border class; the quirk position of the plain packed flood and its
tile mirror; the CLI's ``--backend sharded``.  JAX's compiled functions are
kept in a module-level dict by shape, so each compiles once.  Card tests
(``cuda``) hold K1's block mode, K1's large windows, K2's quirk position and
the sharded model on the card against their plain versions.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from canny_edge_tpu import golden
from canny_edge_tpu.io.imageio import synthetic_image
from canny_edge_tpu_torch.kernels import frontend as kfe
from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.ops import packed as P
from canny_edge_tpu_torch.ops import packed_tiles as Tl
from canny_edge_tpu_torch.ops import window as Wn
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
from canny_edge_tpu_torch.parallel import (ShardedCanny, halo_exchange_2d,
                                           halo_exchange_cols,
                                           halo_exchange_rows, make_mesh)
from canny_edge_tpu_torch.parallel import sharded as S

E = 255
CPU = torch.device("cpu")
# every factorization of 8 blocks into (data, y, x)
MESHES = [(1, 1, 8), (1, 8, 1), (1, 2, 4), (1, 4, 2), (2, 2, 2),
          (2, 1, 4), (2, 4, 1), (4, 2, 1), (4, 1, 2), (8, 1, 1)]

_JAX = {}          # compiled JAX functions by what they compute and shape


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def mesh8(d, y, x, dev=CPU):
    return make_mesh([dev] * 8, data=d, y=y, x=x)


def run(model, imgs, mn, mx):
    return model(model.shard_batch(imgs), mn, mx).cpu().numpy()


def nm_of(img, sigma):
    return golden.nonmax_suppression(*golden.sobel(
        golden.gaussian_blur(img, sigma)))


def strict_oracle(img, sigma, mn, mx):
    return golden.hysteresis_bfs(nm_of(img, sigma), mn, mx)


# ---------------------------------------------------------------------------
# counterparts of tests/test_sharded.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(1, 2, 4), (1, 4, 2), (2, 2, 2),
                                        (8, 1, 1), (1, 1, 8)])
def test_sharded_bitexact(mesh_shape):
    d, y, x = mesh_shape
    model = ShardedCanny(mesh8(d, y, x), sigma=1.0, image_shape=(128, 256))
    imgs = np.stack([synthetic_image(128, 256, seed=i) for i in range(2 * d)])
    out = run(model, imgs, 30, 90)
    for i in range(2 * d):
        np.testing.assert_array_equal(out[i], golden.canny(imgs[i], 1.0, 30, 90))


def test_sharded_bitexact_test_image(test_image):
    model = ShardedCanny(mesh8(1, 2, 4), sigma=1.0, image_shape=(256, 256))
    out = run(model, test_image[None], 50, 150)
    np.testing.assert_array_equal(out[0], golden.canny(test_image, 1.0, 50, 150))


def test_sharded_large_sigma_halo():
    """sigma 2 -> window 13 -> halo 6: wide halos cross block boundaries."""
    model = ShardedCanny(mesh8(1, 2, 4), sigma=2.0, image_shape=(64, 128))
    img = synthetic_image(64, 128, seed=5)
    np.testing.assert_array_equal(run(model, img[None], 20, 60)[0],
                                  golden.canny(img, 2.0, 20, 60))


def test_sharded_snaking_edge_crosses_shards():
    """A serpentine weak path from one strong pixel crosses every block
    boundary (many rounds of the distributed fixed point)."""
    H, W = 64, 128
    img = np.zeros((H, W), np.uint8)
    for r in range(4, H - 4, 8):
        img[r, 4:W - 4] = 200
    for i, r in enumerate(range(4, H - 12, 8)):
        img[r:r + 9, W - 5 if i % 2 == 0 else 4] = 200
    model = ShardedCanny(mesh8(1, 2, 4), sigma=0.5, image_shape=(H, W),
                         hysteresis_steps=4)
    np.testing.assert_array_equal(run(model, img[None], 10, 60)[0],
                                  golden.canny(img, 0.5, 10, 60))


@pytest.mark.parametrize("shape,min_val", [((129, 250), 30), ((127, 253), 0)])
def test_sharded_nondivisible_pad_mask(shape, min_val):
    """Any shape: padded to the block grid, the padding never weak (min 0)."""
    H, W = shape
    model = ShardedCanny(mesh8(1, 2, 4), sigma=1.0, image_shape=(H, W))
    assert model.Hp % 2 == 0 and model.Wp % 4 == 0
    img = synthetic_image(H, W, seed=11)
    out = run(model, img[None], min_val, 90)
    assert out.shape == (1, H, W)
    np.testing.assert_array_equal(out[0], golden.canny(img, 1.0, min_val, 90))


def test_sharded_tiny_image_pads_to_halo():
    """Blocks smaller than the widest halo are grown by padding."""
    model = ShardedCanny(mesh8(1, 2, 4), sigma=2.0, image_shape=(16, 32),
                         hysteresis_steps=16)
    img = synthetic_image(16, 32, seed=3)
    np.testing.assert_array_equal(run(model, img[None], 20, 60)[0],
                                  golden.canny(img, 2.0, 20, 60))


def test_sharded_call_pads_unpadded_input():
    """__call__ takes an unpadded (B, H, W) array or tensor directly."""
    model = ShardedCanny(mesh8(1, 2, 4), sigma=1.0, image_shape=(66, 130))
    img = synthetic_image(66, 130, seed=7)
    ref = golden.canny(img, 1.0, 30, 90)
    np.testing.assert_array_equal(model(img[None], 30, 90)[0].numpy(), ref)
    np.testing.assert_array_equal(
        model(torch.from_numpy(img[None]), 30, 90)[0].numpy(), ref)


def test_sharded_engine_selection():
    """The static engine on normal geometry; the generic one where an
    interior block's dependency cone leaves the image; JAX's errors."""
    mesh = mesh8(1, 2, 4)
    assert ShardedCanny(mesh, 1.0, (128, 256)).engine == "static"
    assert ShardedCanny(mesh, 2.0, (10, 12)).engine == "generic"
    with pytest.raises(ValueError):
        ShardedCanny(mesh, 2.0, (10, 12), frontend="static")
    for kw in ({"frontend": "nope"}, {"flood": "nope"},
               {"hysteresis_mode": "nope"}):
        with pytest.raises(ValueError):
            ShardedCanny(mesh, 1.0, (64, 64), **kw)
    model = ShardedCanny(mesh, 1.0, (64, 64))
    with pytest.raises(ValueError, match="expected"):
        model(np.zeros((64, 64), np.uint8), 30, 90)
    with pytest.raises(ValueError, match="data axis"):
        ShardedCanny(mesh8(2, 2, 2), 1.0, (64, 64))(
            np.zeros((3, 64, 64), np.uint8), 30, 90)


@pytest.mark.parametrize("flood", ["xla", "vmem"])
def test_sharded_static_floods_bitexact(flood):
    """Both distributed floods (the plain packed flood; K2's wrapper, which
    takes its plain version on a CPU tensor) on a spatial mesh."""
    model = ShardedCanny(mesh8(1, 2, 4), sigma=1.4, image_shape=(96, 200),
                         flood=flood)
    assert model.engine == "static" and model.flood == flood
    img = synthetic_image(96, 200, seed=3)
    np.testing.assert_array_equal(
        run(model, img[None], 30, 90)[0],
        golden.hysteresis(nm_of(img, 1.4), 30, 90))


def test_sharded_static_matches_generic():
    img = synthetic_image(66, 120, seed=11)
    st = ShardedCanny(mesh8(1, 2, 4), 1.0, (66, 120), frontend="static")
    ge = ShardedCanny(mesh8(1, 2, 4), 1.0, (66, 120), frontend="generic")
    assert st.engine == "static" and ge.engine == "generic"
    np.testing.assert_array_equal(run(st, img[None], 0, 90),
                                  run(ge, img[None], 0, 90))


def test_sharded_tall_block_frontend():
    """A block of 1600 rows runs as one K1 block (JAX cut it into bands of
    720 rows, a TPU compile-time policy); bit-equal all the same."""
    model = ShardedCanny(make_mesh([CPU], data=1, y=1, x=1), sigma=1.4,
                         image_shape=(1600, 96))
    assert model.engine == "static"
    img = synthetic_image(1600, 96, seed=5)
    np.testing.assert_array_equal(
        run(model, img[None], 30, 90)[0],
        golden.hysteresis(nm_of(img, 1.4), 30, 90))


# ---------------------------------------------------------------------------
# counterpart of tests/test_fuzz_sharded.py
# ---------------------------------------------------------------------------

def _fuzz_configs():
    rng = np.random.default_rng(20260820)
    cfgs = []
    for i in range(10):
        h = int(rng.integers(16, 400))
        w = int(rng.integers(16, 400))
        sigma = float(rng.choice([0.5, 1.0, 1.4, 2.0, 2.5]))
        mn = int(rng.integers(0, 80))
        mx = mn + int(rng.integers(1, 120))
        cfgs.append((i, h, w, sigma, mn, mx, *MESHES[i % len(MESHES)]))
    cfgs.append((10, 131, 251, 1.0, 30, 90, 1, 2, 4))
    cfgs.append((11, 10, 12, 2.0, 20, 60, 1, 2, 4))
    cfgs.append((12, 97, 203, 1.0, 0, 40, 2, 2, 2))
    return cfgs


@pytest.mark.parametrize("i,h,w,sigma,mn,mx,d,my,mx_", _fuzz_configs())
def test_fuzz_sharded_bitexact(i, h, w, sigma, mn, mx, d, my, mx_):
    model = ShardedCanny(mesh8(d, my, mx_), sigma=sigma, image_shape=(h, w))
    rng = np.random.default_rng(2000 + i)
    imgs = rng.integers(0, 256, (d, h, w), np.uint8)
    out = run(model, imgs, mn, mx)
    assert out.shape == (d, h, w)
    for b in range(d):
        np.testing.assert_array_equal(
            out[b], golden.canny(imgs[b], sigma, mn, mx),
            err_msg=f"config {i}: {h}x{w} sigma={sigma} thr=({mn},{mx}) "
                    f"mesh=({d},{my},{mx_}) engine={model.engine}")


def test_fuzz_covers_both_engines():
    engines, padded = set(), 0
    for (i, h, w, sigma, mn, mx, d, my, mx_) in _fuzz_configs():
        model = ShardedCanny(mesh8(d, my, mx_), sigma=sigma, image_shape=(h, w))
        engines.add(model.engine)
        padded += (model.Hp, model.Wp) != (h, w)
    assert engines == {"static", "generic"}
    assert padded >= 5


def test_engine_and_geometry_equal_jax():
    """Every fuzz configuration picks JAX's engine and block grid."""
    from canny_edge_tpu.parallel import ShardedCanny as JShardedCanny
    from canny_edge_tpu.parallel import make_mesh as jmake_mesh

    for (i, h, w, sigma, mn, mx, d, my, mx_) in _fuzz_configs():
        ours = ShardedCanny(mesh8(d, my, mx_), sigma=sigma, image_shape=(h, w))
        ref = JShardedCanny(jmake_mesh(data=d, y=my, x=mx_), sigma=sigma,
                            image_shape=(h, w))
        assert (ours.engine, ours.Hp, ours.Wp) == (ref.engine, ref.Hp, ref.Wp)


# ---------------------------------------------------------------------------
# the sharded cases of tests/test_strict_mode.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["xla", "vmem"])
def test_strict_mode_distributed_flood(engine):
    """The quirk fires on the top-left block only, at extended (1, 1),
    while a second component floods across three block boundaries."""
    nm = np.zeros((16, 128), np.int16)
    nm[1, 0] = 10
    nm[0, 1:6] = 3
    nm[7, 10:120] = 5
    nm[7, 100] = 10
    mesh = mesh8(1, 2, 4)
    t = torch.from_numpy(nm)
    masks = {}
    for b in mesh.local_blocks:
        blk = t[b[1] * 8:(b[1] + 1) * 8, b[2] * 32:(b[2] + 1) * 32]
        masks[b] = (P.pack_mask(blk >= 2), P.pack_mask(blk >= 10))
    edges, rounds = S._flood_distributed(masks, mesh, 8, 32, engine,
                                         strict=True)
    assert rounds >= 2
    out = np.zeros((16, 128), np.int16)
    for b, e in edges.items():
        out[b[1] * 8:(b[1] + 1) * 8, b[2] * 32:(b[2] + 1) * 32] = e.numpy()
    np.testing.assert_array_equal(out, golden.hysteresis_bfs(nm, 2, 10))
    assert out[0, 1] == 0
    assert golden.hysteresis(nm, 2, 10)[0, 1] == E
    assert out[7, 10:120].min() == E


@pytest.mark.parametrize("mesh_shape,frontend", [((1, 2, 4), "static"),
                                                 ((1, 1, 8), "static"),
                                                 ((1, 2, 4), "generic")])
def test_strict_mode_sharded_end_to_end(mesh_shape, frontend, test_image):
    model = ShardedCanny(mesh8(*mesh_shape), sigma=1.0,
                         image_shape=test_image.shape, frontend=frontend,
                         hysteresis_mode="strict-reference")
    assert model.engine == frontend
    np.testing.assert_array_equal(run(model, test_image[None], 50, 150)[0],
                                  strict_oracle(test_image, 1.0, 50, 150))


def _quirk_image(shape=(128, 256)):
    """Strict and component outputs diverge at (0, 1) with (144, 145)."""
    corner = np.array([[122, 140, 225, 71, 74],
                       [230, 67, 252, 59, 57],
                       [136, 47, 164, 232, 168],
                       [128, 9, 222, 235, 150]], np.uint8)
    img = np.zeros(shape, np.uint8)
    img[0:4, 0:5] = corner
    img[shape[0] // 2, shape[1] // 2] = 200
    return img


@pytest.mark.parametrize("frontend", ["static", "generic"])
def test_strict_mode_sharded_quirk_divergence(frontend):
    img = _quirk_image()
    nm = nm_of(img, 0.5)
    outs = {}
    for mode in ("strict-reference", "component"):
        model = ShardedCanny(mesh8(1, 2, 4), sigma=0.5, image_shape=img.shape,
                             frontend=frontend, hysteresis_mode=mode)
        outs[mode] = run(model, img[None], 144, 145)[0]
    np.testing.assert_array_equal(outs["strict-reference"],
                                  golden.hysteresis_bfs(nm, 144, 145))
    np.testing.assert_array_equal(outs["component"],
                                  golden.hysteresis(nm, 144, 145))
    assert outs["strict-reference"][0, 1] == 0 and outs["component"][0, 1] == E


def test_strict_mode_cli_sharded(tmp_path, test_image):
    """--backend sharded --hysteresis strict-reference through the port's
    command line, its PNG equal to the BFS oracle."""
    from canny_edge_tpu_torch import cli
    from canny_edge_tpu_torch.io.imageio import load_grayscale, save_png

    src = str(tmp_path / "in.png")
    save_png(src, test_image)
    out_path = str(tmp_path / "out.png")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([src, "1.0", "50", "150", "-o", out_path, "--hysteresis",
                       "strict-reference", "--backend", "sharded",
                       "--device", "cpu"])
    assert rc == 0
    np.testing.assert_array_equal(
        load_grayscale(out_path),
        strict_oracle(test_image, 1.0, 50, 150).astype(np.uint8))


# ---------------------------------------------------------------------------
# against JAX's ShardedCanny on the same mesh and inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,shape,sigma,mode,batch", [
    ((1, 2, 4), (72, 160), 1.4, "component", 1),         # static
    ((1, 2, 4), (10, 12), 2.0, "component", 1),          # generic
    ((1, 2, 4), (72, 160), 1.0, "strict-reference", 1),  # strict
    ((2, 2, 2), (66, 98), 1.0, "component", 4),          # data-parallel
])
def test_sharded_equals_jax_sharded(mesh_shape, shape, sigma, mode, batch):
    from canny_edge_tpu.parallel import ShardedCanny as JShardedCanny
    from canny_edge_tpu.parallel import make_mesh as jmake_mesh

    d, y, x = mesh_shape
    rng = np.random.default_rng(sum(shape) + batch)
    imgs = rng.integers(0, 256, (batch,) + shape, np.uint8)
    imgs[:, shape[0] // 3, :] = 255          # a long edge across blocks
    ref_model = JShardedCanny(jmake_mesh(data=d, y=y, x=x), sigma=sigma,
                              image_shape=shape, hysteresis_mode=mode)
    ref = np.asarray(ref_model(ref_model.shard_batch(imgs), 20, 80))
    model = ShardedCanny.from_numpy_params(
        mesh8(d, y, x), np.asarray(ref_model.kernel), shape,
        hysteresis_mode=mode)
    assert model.engine == ref_model.engine
    np.testing.assert_array_equal(run(model, imgs, 20, 80), ref)


# ---------------------------------------------------------------------------
# the pieces against JAX's
# ---------------------------------------------------------------------------

def _jax_halo(kind, r, mesh_shape, arr):
    import jax
    from jax.sharding import PartitionSpec as Pspec

    from canny_edge_tpu.parallel import halo as J
    from canny_edge_tpu.parallel import make_mesh as jmake_mesh

    key = ("halo", kind, r, mesh_shape, arr.shape)
    if key not in _JAX:
        fn = {"cols": lambda v: J.halo_exchange_cols(v, r, "x"),
              "rows": lambda v: J.halo_exchange_rows(v, r, "y"),
              "2d": lambda v: J.halo_exchange_2d(v, r, "y", "x")}[kind]
        _JAX[key] = jax.jit(jax.shard_map(
            fn, mesh=jmake_mesh(data=1, y=mesh_shape[0], x=mesh_shape[1]),
            in_specs=Pspec("y", "x"), out_specs=Pspec("y", "x"),
            check_vma=False))
    return np.asarray(_JAX[key](arr))


@pytest.mark.parametrize("r,ny,nx", [(0, 2, 4), (1, 2, 4), (3, 2, 4),
                                     (2, 1, 8), (2, 8, 1)])
def test_halo_exchange_equals_jax(r, ny, nx):
    """Columns, rows and the two-phase 2-D exchange (corners included),
    zero-filled at the border and padded along an axis of size 1."""
    hl, wl = 6, 5
    arr = np.random.default_rng(r + ny).integers(
        -1000, 1000, (ny * hl, nx * wl)).astype(np.int32)
    mesh = mesh8(1, ny, nx)
    blocks = {b: torch.from_numpy(arr[b[1] * hl:(b[1] + 1) * hl,
                                      b[2] * wl:(b[2] + 1) * wl].copy())
              for b in mesh.local_blocks}
    for kind, fn in (("cols", halo_exchange_cols), ("rows", halo_exchange_rows),
                     ("2d", halo_exchange_2d)):
        out = fn(blocks, r, mesh)
        got = np.block([[out[(0, y, x)].numpy() for x in range(nx)]
                        for y in range(ny)])
        np.testing.assert_array_equal(got, _jax_halo(kind, r, (ny, nx), arr),
                                      err_msg=kind)


def _jax_window_nm(win, row0, col0, H, W, kern, hl, wl, r):
    import jax.numpy as jnp

    from canny_edge_tpu.ops.window import window_nm

    return np.asarray(window_nm(jnp.asarray(win, jnp.float32), row0 - r,
                                col0 - r, H, W, tuple(float(v) for v in kern),
                                hl, wl, r))


@pytest.mark.parametrize("row0,col0,hl,wl", [
    (0, 0, 24, 64),       # top-left
    (24, 64, 24, 64),     # interior
    (48, 128, 24, 64),    # bottom-right, past the image on both axes
    (24, 0, 24, 180),     # a full-width block (a mesh with one column)
])
def test_block_frontend_equals_jax(row0, col0, hl, wl):
    """ops/window.py:frontend_block (K1 block mode's plain version) against
    JAX's window_nm (and frontend_nm_static for the full-width block), with
    JAX's clearing of the pixels past the image; also the wrapper's CPU
    path."""
    from canny_edge_tpu.ops.packed import pack_mask as jpack
    from canny_edge_tpu.ops.window import frontend_nm_static

    H, W, sigma = 70, 180, 1.4
    kern = gaussian_kernel(sigma)
    r = len(kern) // 2 + 2
    img = synthetic_image(H, W, seed=row0 + col0)
    pad = np.pad(img, ((r, r + 80), (r, r + 80)))
    win = pad[row0:row0 + hl + 2 * r, col0:col0 + wl + 2 * r]
    inside = ((np.arange(hl)[:, None] + row0 < H)
              & (np.arange(wl)[None, :] + col0 < W))
    ref = np.where(inside, _jax_window_nm(win, row0, col0, H, W, kern, hl,
                                          wl, r), 0)
    tw = torch.from_numpy(np.ascontiguousarray(win))
    nm = Wn.frontend_block(tw, row0, col0, H, W, kern)
    np.testing.assert_array_equal(nm.numpy(), ref)
    np.testing.assert_array_equal(
        kfe.frontend_block(tw, row0, col0, H, W,
                           torch.from_numpy(kern)).numpy(), ref)
    for mn, mx in ((30, 90), (0, 40)):
        weak, strong = Wn.frontend_block(tw, row0, col0, H, W, kern, (mn, mx))
        np.testing.assert_array_equal(
            weak.view(torch.int32).numpy(),
            np.asarray(jpack(ref >= mn) & jpack(inside)).view(np.int32))
        np.testing.assert_array_equal(
            strong.view(torch.int32).numpy(),
            np.asarray(jpack(ref >= mx) & jpack(inside)).view(np.int32))
        if wl == W:
            jw, js = frontend_nm_static(win, row0, hl, H, W,
                                        tuple(float(v) for v in kern),
                                        thresholds=(mn, mx))
            np.testing.assert_array_equal(weak.view(torch.int32).numpy(),
                                          np.asarray(jw).view(np.int32))
            np.testing.assert_array_equal(strong.view(torch.int32).numpy(),
                                          np.asarray(js).view(np.int32))


def test_strict_fix_packed_quirk_position_equals_jax():
    """strict_fix_packed at (row 1, word 1) against JAX's, on random words,
    and the whole strict flood of a halo-extended mask at quirk_rw=(1, 1)
    against JAX's hysteresis_packed_masks (K2's wrapper on a CPU tensor too,
    and the tile mirror, whose steps bound the kernel's)."""
    import jax.numpy as jnp

    from canny_edge_tpu.ops import packed as J

    rng = np.random.default_rng(4)
    new, prev, weak = (rng.integers(0, 2 ** 32, (6, 4), dtype=np.uint64)
                       .astype(np.uint32) for _ in range(3))
    ours = P.strict_fix_packed(P.from_words(torch.from_numpy(new)),
                               P.from_words(torch.from_numpy(prev)),
                               P.from_words(torch.from_numpy(weak)), 1, 1)
    ref = np.asarray(J.strict_fix_packed(jnp.asarray(new), jnp.asarray(prev),
                                         jnp.asarray(weak), 1, 1))
    np.testing.assert_array_equal(P.to_words(ours).numpy(), ref)

    # a 16x64 block of a larger image, extended by a row and a word: global
    # pixel (0, 0) at row 1, word 1; (1, 0) strong, (0, 1) weak only
    nm = np.zeros((18, 4 * 32), np.int32)
    nm[2, 32] = 10
    nm[1, 33:40] = 3
    nm[9, 40:120] = 5
    nm[9, 100] = 10
    w, s = P.pack_mask(torch.from_numpy(nm >= 2)), P.pack_mask(
        torch.from_numpy(nm >= 10))
    ref, _ = J.hysteresis_packed_masks(jnp.asarray(w.numpy()),
                                       jnp.asarray(s.numpy()), 18, 128,
                                       strict=True, quirk_rw=(1, 1))
    ref = np.asarray(ref).view(np.int32)
    ours, _ = P.hysteresis_packed_masks(w, s, 18, 128, strict=True,
                                        quirk_rw=(1, 1))
    wrapped = khp.hysteresis_packed(w, s, 18, 128, strict=True,
                                    quirk_rw=(1, 1))
    mirror, _, _ = Tl.hysteresis_packed_tiles(w, s, 18, 128, strict=True,
                                              quirk_rw=(1, 1))
    for got in (ours, wrapped, mirror):
        np.testing.assert_array_equal(got.view(torch.int32).numpy(), ref)
    comp, _ = P.hysteresis_packed_masks(w, s, 18, 128)
    assert int(P.from_words(ours)[1, 1]) & 2 == 0       # the quirk held
    assert int(P.from_words(comp)[1, 1]) & 2 == 2


@pytest.mark.parametrize("quirk", [(0, 0), (7, 1), (8, 2), (17, 3)])
def test_quirk_position_mirror_equals_plain(quirk):
    """The tile mirror of K2 puts the fix in any tile, the row below a
    tile's last read from the next tile, as the plain flood does."""
    rng = np.random.default_rng(quirk[0])
    weak = rng.random((18, 128)) < 0.6
    weak[quirk[0], 32 * quirk[1] + 1] = True
    strong = weak & (rng.random((18, 128)) < 0.05)
    w, s = (P.pack_mask(torch.from_numpy(m)) for m in (weak, strong))
    ref, _ = P.hysteresis_packed_masks(w, s, 18, 128, strict=True,
                                       quirk_rw=quirk)
    for tile in ((8, 32), (8, 2), (3, 1)):
        got, _, _ = Tl.hysteresis_packed_tiles(w, s, 18, 128, tile=tile,
                                               strict=True, quirk_rw=quirk)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), tile


def test_multi_device_modules_load_no_jax():
    """The new modules import neither JAX nor the JAX package."""
    code = ("import sys; before = set(sys.modules); "
            "import canny_edge_tpu_torch.parallel, "
            "canny_edge_tpu_torch.parallel.halo, "
            "canny_edge_tpu_torch.parallel.sharded, "
            "canny_edge_tpu_torch.parallel.multihost, "
            "canny_edge_tpu_torch.ops, canny_edge_tpu_torch.kernels, "
            "canny_edge_tpu_torch.utils; "
            "bad = [m for m in set(sys.modules) - before if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'canny_edge_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr


def test_make_mesh_shapes_and_errors():
    """JAX's factoring, its error on a mesh of another size, and one block
    of this process's device without a list."""
    assert make_mesh([CPU] * 8).shape == {"data": 1, "y": 2, "x": 4}
    assert make_mesh([CPU] * 8, data=2).shape == {"data": 2, "y": 2, "x": 2}
    assert make_mesh([CPU] * 8, y=8).shape == {"data": 1, "y": 8, "x": 1}
    with pytest.raises(ValueError, match="mesh 1x2x2 != 8 devices"):
        make_mesh([CPU] * 8, data=1, y=2, x=2)
    mesh = make_mesh([CPU])
    assert mesh.shape == {"data": 1, "y": 1, "x": 1} and mesh.ranks is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [2.7, 3.4, 4.0, 5.0, 5.4, 6.0, 9.0])
def test_card_k1_large_windows(cuda_device, sigma):
    """K1 at windows 17 to 55 (the generic instantiation) against its plain
    version, in NMS and mask mode, on 1080p and an odd shape."""
    kern = gaussian_kernel(sigma)
    taps = torch.from_numpy(kern).to(cuda_device)
    rng = np.random.default_rng(len(kern))
    for h, w in ((1080, 1920), (257, 333)):
        img = torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8)).to(
            cuda_device)
        ref = Wn.frontend_nm(img, kern)
        assert torch.equal(kfe.frontend(img, taps).to(torch.int32), ref)
        weak, strong = kfe.frontend(img, taps, (30, 90))
        assert torch.equal(weak.view(torch.int32),
                           P.pack_mask(ref >= 30).view(torch.int32))
        assert torch.equal(strong.view(torch.int32),
                           P.pack_mask(ref >= 90).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.4, 6.0])
def test_card_k1_block_mode(cuda_device, sigma):
    """K1 block mode against its plain version at every border class of a
    4K frame, and a block past the image."""
    kern = gaussian_kernel(sigma)
    taps = torch.from_numpy(kern).to(cuda_device)
    r = len(kern) // 2 + 2
    H, W = 2160, 3840
    img = torch.from_numpy(synthetic_image(H, W, seed=2)).to(cuda_device)
    pad = F.pad(img, (r, r + 64, r, r + 128))
    for row0, col0, hl, wl in ((0, 0, 1080, 960), (1080, 960, 1080, 960),
                               (1080, 2880, 1080, 960), (720, 0, 720, 3840),
                               (2048, 3808, 128, 64)):
        win = pad[row0:row0 + hl + 2 * r, col0:col0 + wl + 2 * r].contiguous()
        for th in (None, (30, 90), (0, 40)):
            a = kfe.frontend_block(win, row0, col0, H, W, taps, th)
            b = Wn.frontend_block(win, row0, col0, H, W, kern, th)
            if th is None:
                assert torch.equal(a.to(torch.int32), b)
            else:
                for u, v in zip(a, b):
                    assert torch.equal(u.view(torch.int32), v.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("quirk", [(1, 1), (0, 0), (7, 1), (8, 2), (17, 3)])
def test_card_k2_quirk_position(cuda_device, quirk):
    """K2 with the strict fix in any tile against the plain flood; its
    steps at most its tile mirror's."""
    rng = np.random.default_rng(quirk[0] + 1)
    weak = rng.random((18, 128)) < 0.6
    weak[quirk[0], 32 * quirk[1] + 1] = True
    strong = weak & (rng.random((18, 128)) < 0.05)
    w, s = (P.pack_mask(torch.from_numpy(m)) for m in (weak, strong))
    ref, _ = P.hysteresis_packed_masks(w, s, 18, 128, strict=True,
                                       quirk_rw=quirk)
    _, mirror_steps, _ = Tl.hysteresis_packed_tiles(w, s, 18, 128, strict=True,
                                                    quirk_rw=quirk)
    out, steps = khp.hysteresis_packed(w.to(cuda_device), s.to(cuda_device),
                                       18, 128, strict=True, quirk_rw=quirk,
                                       return_steps=True)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
    assert 1 <= int(steps) <= mirror_steps


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape,mode", [((1, 2, 2), "component"),
                                             ((1, 2, 4), "strict-reference"),
                                             ((2, 2, 2), "component")])
def test_card_sharded_equals_fused(cuda_device, mesh_shape, mode):
    """ShardedCanny over in-process meshes on the card, bit-equal to
    CannyTorch's fused backend, through K1 block mode and K2."""
    from canny_edge_tpu_torch import CannyTorch

    H, W = 540, 960
    imgs = np.stack([synthetic_image(H, W, seed=i) for i in range(2)])
    model = ShardedCanny(make_mesh([cuda_device] * 8 if mesh_shape != (1, 2, 2)
                                   else [cuda_device] * 4, data=mesh_shape[0],
                                   y=mesh_shape[1], x=mesh_shape[2]),
                         sigma=1.4, image_shape=(H, W), hysteresis_mode=mode)
    assert model.engine == "static" and model.flood == "vmem"
    before = kfe.block_launches
    out = model(imgs, 30, 90)
    assert kfe.block_launches > before
    ref = CannyTorch(1.4, hysteresis_mode=mode).batch(imgs, 30, 90)
    assert torch.equal(out, ref)


def test_cli_sharded_equals_jax_cli(tmp_path):
    """``--backend sharded`` (a 1x1x1 mesh of the CPU) writes the PNGs of
    JAX's command line (its 1x2x4 mesh of fake devices) and of the port's
    fused backend."""
    from canny_edge_tpu.cli import main as jax_main
    from canny_edge_tpu_torch import cli
    from canny_edge_tpu_torch.io.imageio import load_grayscale

    argv = ["synthetic:64x96x4", "1.4", "30", "90", "--batch", "2"]
    runs = {"sharded": (cli.main, ["--backend", "sharded", "--device", "cpu"]),
            "fused": (cli.main, ["--device", "cpu"]),
            "jax": (jax_main, ["--backend", "sharded"])}
    for name, (main, extra) in runs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + extra + ["--out-dir",
                                        str(tmp_path / name)]) == 0
    for i in range(4):
        got = [load_grayscale(str(tmp_path / n / f"edges_{i:06d}.png"))
               for n in runs]
        assert got[0].any()
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])
