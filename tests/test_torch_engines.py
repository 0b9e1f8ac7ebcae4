"""PyTorch port: the K3 (tiled dilation) and K4 (banded raster scan)
hysteresis engines as one-launch kernels.

On the CPU: the plain mirrors of the kernels' schedules, K4's step-skipping
rule (``ops/banded_skip.py``) and K3's dirty-tile rule
(``ops/dilate_tiles.py``), against the same loops with nothing skipped (every
intermediate state), against the plain versions ``ops/banded.py`` /
``ops/dilate.py`` (result and sweeps), the NumPy oracle and the JAX engines
(Pallas in interpret mode); the scratch the kernels' wrappers share; and the
C entries' signatures against the sources.  On the card: the kernels against
the plain versions with equal sweep counts.  Tolerance: 0 differing pixels
everywhere.

Inputs are made from NumPy seeds and cross between the frameworks as NumPy
arrays; JAX runs on the CPU.
"""

import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu import golden
from canny_edge_tpu_torch.kernels import _build, _scratch
from canny_edge_tpu_torch.kernels import hysteresis as k3
from canny_edge_tpu_torch.kernels import hysteresis_v2 as k4
from canny_edge_tpu_torch.ops import banded, dilate
from canny_edge_tpu_torch.ops.banded_skip import hysteresis_banded_skip
from canny_edge_tpu_torch.ops.dilate_tiles import hysteresis_dilate_tiles


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _snake(h, w):
    """Serpentine weak chain with one strong seed: many sweeps."""
    nm = np.zeros((h, w), np.int16)
    for r in range(4, h - 4, 8):
        nm[r, 4:w - 4] = 30
    for i, r in enumerate(range(4, h - 12, 8)):
        c = w - 5 if i % 2 == 0 else 4
        nm[r:r + 9, c] = 30
    nm[4, 4] = 200
    return nm


def _spiral(n=40):
    """Inward spiral, one connected chain, strong seed at its centre end:
    every turn reverses the direction of the flood."""
    nm = np.zeros((n, n), np.int16)
    r0, c0, r1, c1 = 0, 0, n - 1, n - 1
    pts = []
    while r0 <= r1 and c0 <= c1:
        pts += [(r0, c) for c in range(c0, c1 + 1)]
        pts += [(r, c1) for r in range(r0 + 1, r1 + 1)]
        if r0 < r1:
            pts += [(r1, c) for c in range(c1 - 1, c0 - 1, -1)]
        if c0 < c1:
            pts += [(r, c0) for r in range(r1 - 1, r0 + 1, -1)]
            pts.append((r0 + 2, c0 + 1))   # the step onto the next ring
        r0, c0, r1, c1 = r0 + 2, c0 + 2, r1 - 2, c1 - 2
    for p in pts:
        nm[p] = 30
    nm[pts[-1]] = 200
    return nm


def _rand_nm(h, w, seed, dtype=np.int16):
    rng = np.random.default_rng(seed)
    nm = rng.integers(0, 100, (h, w)).astype(dtype)
    nm[rng.random((h, w)) < 0.45] = 0
    return nm


def _sparse_nm(h, w, seed):
    """Long thin weak chains with few seeds: several rounds and sweeps."""
    rng = np.random.default_rng(seed)
    nm = np.zeros((h, w), np.int16)
    nm[rng.random((h, w)) < 0.58] = 30
    nm[rng.random((h, w)) < 0.002] = 200
    return nm


CHAINS = {"snake": lambda: _snake(128, 256), "spiral": _spiral,
          "small-snake": lambda: _snake(48, 140)}
RAGGED = [(1, 1), (1, 50), (40, 1), (33, 31)]
PAIRS = [(0, 40), (30, 90), (60, 99)]
BANDS = [None, 1, 8, 16]
TILES = [(128, 512), (8, 32), (16, 100)]


# ---------------------------------------------------------------------------
# K4's step-skipping rule
# ---------------------------------------------------------------------------

def _check_banded(nm, mn, mx, band_h):
    t = torch.from_numpy(nm)
    out, sweeps, st = hysteresis_banded_skip(t, mn, mx, band_h=band_h)
    full, fsweeps, fst = hysteresis_banded_skip(t, mn, mx, band_h=band_h,
                                                skip=False)
    ref, rsweeps = banded.hysteresis_banded(t, mn, mx, band_h=band_h,
                                            return_sweeps=True)
    tag = f"{nm.shape} {mn}/{mx} band_h {band_h}"
    assert torch.equal(out, ref) and torch.equal(full, ref), tag
    assert sweeps == fsweeps == rsweeps, tag
    assert st["rounds"] == fst["rounds"], tag
    assert len(st["states"]) == len(fst["states"]), tag
    for a, b in zip(st["states"], fst["states"]):
        assert torch.equal(a, b), tag
    assert st["steps"] <= fst["steps"], tag
    return st, fst


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("band_h", BANDS)
def test_banded_skip_random(shape, band_h):
    h, w = shape
    for k, (mn, mx) in enumerate(PAIRS):
        _check_banded(_rand_nm(h, w, seed=7 * h + w + k), mn, mx, band_h)


@pytest.mark.parametrize("band_h", [None, 16])
def test_banded_skip_random_130x300(band_h):
    _check_banded(_rand_nm(130, 300, seed=3), 30, 90, band_h)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("band_h", [4, 16])
def test_banded_skip_sparse_chains(seed, band_h):
    st, _ = _check_banded(_sparse_nm(70, 90, seed), 10, 100, band_h)
    assert max(max(r) for r in st["rounds"]) >= 2      # rounds that skip


@pytest.mark.parametrize("name,band_h", [
    ("snake", None), ("snake", 16), ("spiral", None), ("spiral", 1),
    ("spiral", 8), ("spiral", 16)])
def test_banded_skip_chains(name, band_h):
    nm = CHAINS[name]()
    st, fst = _check_banded(nm, 10, 100, band_h)
    ref = golden.hysteresis(nm, 10, 100)
    out, _, _ = hysteresis_banded_skip(torch.from_numpy(nm), 10, 100,
                                       band_h=band_h)
    np.testing.assert_array_equal(out.numpy(), ref)
    if max(max(r) for r in st["rounds"]) >= 2:
        assert st["steps"] < fst["steps"]              # the rule saves steps


def test_banded_skip_negative_and_inverted_thresholds():
    """nm is compared signed, and seeds that are not weak (max < min) stay."""
    nm = _rand_nm(30, 70, seed=5, dtype=np.int32) - 20
    _check_banded(nm, 0, 40, 8)
    _check_banded(nm, 40, 10, 8)
    out, _, _ = hysteresis_banded_skip(torch.from_numpy(nm), 0, 40, band_h=8)
    np.testing.assert_array_equal(out.numpy(), golden.hysteresis(nm, 0, 40))


def test_banded_skip_vs_pallas():
    from canny_edge_tpu.kernels.hysteresis_v2 import hysteresis_banded
    import jax
    import jax.numpy as jnp

    nm = _spiral()
    ref = np.asarray(jax.jit(lambda x: hysteresis_banded(
        x.astype(jnp.int32), 10, 100, band_h=16))(nm))
    out, _, _ = hysteresis_banded_skip(torch.from_numpy(nm), 10, 100, band_h=16)
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# K3's dirty-tile rule
# ---------------------------------------------------------------------------

def _check_dilate(nm, mn, mx, tile):
    t = torch.from_numpy(nm)
    out, sweeps, st = hysteresis_dilate_tiles(t, mn, mx, tile=tile)
    full, fsweeps, fst = hysteresis_dilate_tiles(t, mn, mx, tile=tile,
                                                 skip=False)
    ref, rsweeps = dilate.hysteresis_dilate(t, mn, mx, tile=tile,
                                            return_sweeps=True)
    tag = f"{nm.shape} {mn}/{mx} tile {tile}"
    assert torch.equal(out, ref) and torch.equal(full, ref), tag
    assert sweeps == fsweeps == rsweeps, tag
    for a, b in zip(st["states"], fst["states"]):
        assert torch.equal(a, b), tag
    assert all(a <= b for a, b in zip(st["floods"], fst["floods"])), tag
    return st, fst


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("tile", TILES)
def test_dilate_tiles_random(shape, tile):
    h, w = shape
    for k, (mn, mx) in enumerate(PAIRS):
        _check_dilate(_rand_nm(h, w, seed=11 * h + w + k), mn, mx, tile)


@pytest.mark.parametrize("tile", [(128, 512), (16, 100)])
def test_dilate_tiles_random_130x300(tile):
    _check_dilate(_rand_nm(130, 300, seed=3), 30, 90, tile)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tile", [(8, 32), (16, 20)])
def test_dilate_tiles_sparse_chains(seed, tile):
    st, _ = _check_dilate(_sparse_nm(70, 150, seed), 10, 100, tile)
    assert len(st["floods"]) > 2                       # sweeps that skip


@pytest.mark.parametrize("name,tile", [
    ("small-snake", (128, 512)), ("small-snake", (16, 128)),
    ("spiral", (128, 512)), ("spiral", (16, 20)), ("spiral", (8, 32))])
def test_dilate_tiles_chains(name, tile):
    nm = CHAINS[name]()
    st, fst = _check_dilate(nm, 10, 100, tile)
    out, _, _ = hysteresis_dilate_tiles(torch.from_numpy(nm), 10, 100, tile=tile)
    np.testing.assert_array_equal(out.numpy(), golden.hysteresis(nm, 10, 100))
    if len(st["floods"]) > 3 and fst["floods"][0] > 9:
        assert sum(st["floods"]) < sum(fst["floods"])  # the rule saves floods


def test_dilate_tiles_serpentine_floods_few_tiles():
    """On the serpentine a sweep past the first two floods the few tiles
    around the chain's head, not all of them."""
    st, fst = _check_dilate(_snake(48, 140), 10, 100, (8, 32))
    assert fst["floods"][0] == 6 * 5 and len(st["floods"]) > 20
    assert max(st["floods"][2:]) <= 12


def test_dilate_tiles_negative_and_inverted_thresholds():
    nm = _rand_nm(30, 70, seed=5, dtype=np.int32) - 20
    _check_dilate(nm, 0, 40, (8, 32))
    _check_dilate(nm, 40, 10, (8, 32))
    out, _, _ = hysteresis_dilate_tiles(torch.from_numpy(nm), 0, 40)
    np.testing.assert_array_equal(out.numpy(), golden.hysteresis(nm, 0, 40))


def test_dilate_tiles_vs_pallas():
    from canny_edge_tpu.kernels import hysteresis_pallas
    import jax
    import jax.numpy as jnp

    nm = _sparse_nm(64, 256, seed=1)
    ref = np.asarray(jax.jit(lambda x: hysteresis_pallas(
        x.astype(jnp.int32), 10, 100, tile=(16, 128)))(nm))
    out, sweeps, _ = hysteresis_dilate_tiles(torch.from_numpy(nm), 10, 100,
                                             tile=(16, 128))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert sweeps > 2


# ---------------------------------------------------------------------------
# what the wrappers share
# ---------------------------------------------------------------------------

def test_scratch_entries_and_tokens():
    cache = _scratch.Scratch()
    cpu = torch.device("cpu")
    assert cache.lookup(cpu, 0, (4, 40)) is None
    a = cache.create(cpu, 0, (4, 40), 5)
    assert a["ctl"].dtype == torch.int64 and a["ctl"].tolist() == [0] * 5
    assert cache.lookup(cpu, 0, (4, 40)) is a
    assert cache.lookup(cpu, 1, (4, 40)) is None       # another stream
    assert cache.lookup(cpu, 0, (4, 40, 8)) is None    # another band
    buf = _scratch.buffer(a, "weak", 4, 40, cpu)
    assert buf.dtype == torch.uint32 and buf.shape == (4, 2)
    assert _scratch.buffer(a, "weak", 4, 40, cpu) is buf
    # the least recently used entry goes first
    for i in range(_scratch.MAX_ENTRIES - 1):
        cache.create(cpu, 0, (100 + i, 8), 1)
        assert cache.lookup(cpu, 0, (4, 40)) is a
    assert len(cache) == _scratch.MAX_ENTRIES
    cache.create(cpu, 0, (200, 8), 1)
    assert len(cache) == _scratch.MAX_ENTRIES
    assert cache.lookup(cpu, 0, (4, 40)) is a
    assert cache.lookup(cpu, 0, (100, 8)) is None
    t1, t2 = _scratch.next_token(), _scratch.next_token()
    assert t2 - t1 == 1 << 32 and t1 % (1 << 32) == 0


def test_wrappers_cpu_stats_and_launch_counts():
    nm = torch.from_numpy(_rand_nm(50, 70, seed=1))
    before = (k3.launches, k4.launches)
    out, st = k3.dilate_stats(nm, 30, 90, tile=(16, 128))
    ref, sweeps = dilate.hysteresis_dilate(nm, 30, 90, tile=(16, 128),
                                           return_sweeps=True)
    assert torch.equal(out, ref) and st == {"sweeps": sweeps}
    out, st = k4.banded_stats(nm, 30, 90, band_h=8)
    ref, sweeps = banded.hysteresis_banded(nm, 30, 90, band_h=8,
                                           return_sweeps=True)
    assert torch.equal(out, ref) and st == {"sweeps": sweeps, "band_h": 8}
    assert (k3.launches, k4.launches) == before   # no kernel on the CPU


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entries_match_sources(name):
    """Every C entry the wrappers bind exists in its source with as many
    parameters as its ctypes signature, and no source keeps an entry that
    nothing binds."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = {m.group(1): m.group(2) for m in re.finditer(
        r"^int (canny_\w+)\(([^)]*)\)", body, re.M | re.S)}
    assert set(found) == set(_build.SIGNATURES[name])
    for fn, params in found.items():
        n = 0 if not params.strip() else len(params.split(","))
        assert n == len(_build.SIGNATURES[name][fn]), fn


def test_one_launch_engines_have_no_pass_entries():
    """The pack, sweep and unpack entries of the host-driven engines are
    gone, and the shared header holds no kernel of its own."""
    names = [fn for fns in _build.SIGNATURES.values() for fn in fns]
    assert not [n for n in names if re.search(r"_(pack|unpack|sweep)$", n)]
    assert "__global__" not in (_build.CSRC / "masks.cuh").read_text()
    assert not hasattr(k3, "run_sweeps")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_SHAPES = [(1, 1), (1, 1000), (40, 1), (64, 31), (64, 32), (64, 33),
               (64, 63), (64, 65), (257, 333), (300, 1920)]


def _card_check(nm, mn, mx, *, tiles=((128, 512), (32, 100)),
                bands=(None, 16)):
    for tile in tiles:
        a, sa = k3.hysteresis_dilate(nm, mn, mx, tile=tile, return_sweeps=True)
        b, sb = dilate.hysteresis_dilate(nm, mn, mx, tile=tile,
                                         return_sweeps=True)
        assert torch.equal(a, b) and sa == sb, (tile, mn, sa, sb)
    for band_h in bands:
        a, st = k4.banded_stats(nm, mn, mx, band_h=band_h)
        # the band the card ran: a default band that did not fit was halved
        b, sb = banded.hysteresis_banded(nm, mn, mx, band_h=st["band_h"],
                                         return_sweeps=True)
        assert torch.equal(a, b) and st["sweeps"] == sb, (band_h, mn, st, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_engines_card_vs_plain(cuda_device, shape):
    h, w = shape
    for mn, mx in [(0, 40), (30, 90)]:
        nm = torch.from_numpy(_rand_nm(h, w, seed=h + w + mn)).to(cuda_device)
        _card_check(nm, mn, mx, tiles=[(128, 512), (32, 100), (8, 32)],
                    bands=[None, 16, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1000, 1921, 3840, 7680, 8200, 12000])
def test_engines_card_widths(cuda_device, width):
    """One, two, four and eight words a lane of K4's warp path, and the
    block-wide path past 8192 columns."""
    nm = torch.from_numpy(_sparse_nm(150, width, seed=width)).to(cuda_device)
    _card_check(nm, 10, 100, tiles=[(128, 512)], bands=[None, 16])
    _, st = k4.banded_stats(nm, 10, 100, band_h=16)
    assert st["bands_run"] >= 10 and st["rounds_max"] >= 1


@pytest.mark.cuda
def test_engines_card_int32_and_negative(cuda_device):
    nm = _rand_nm(130, 300, seed=5, dtype=np.int32) - 20
    ref = torch.from_numpy(golden.hysteresis(nm, 0, 40)).to(cuda_device)
    for t in (torch.from_numpy(nm), torch.from_numpy(nm.astype(np.int16))):
        t = t.to(cuda_device)
        assert torch.equal(k3.hysteresis_dilate(t, 0, 40), ref)
        assert torch.equal(k4.hysteresis_banded(t, 0, 40), ref)
    t = torch.from_numpy(nm).to(cuda_device)
    _card_check(t, 40, 10)                       # seeds that are not weak


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small-snake", "spiral"])
def test_engines_card_chains(cuda_device, name):
    """Long chains: result, sweeps, tile floods and rounds as the mirrors."""
    nm = CHAINS[name]()
    ref = torch.from_numpy(golden.hysteresis(nm, 10, 100)).to(cuda_device)
    t = torch.from_numpy(nm).to(cuda_device)
    for tile in [(128, 512), (16, 128), (8, 32)]:
        out, got = k3.dilate_stats(t, 10, 100, tile=tile)
        _, want, st = hysteresis_dilate_tiles(t, 10, 100, tile=tile)
        assert torch.equal(out, ref) and got["sweeps"] == want
        assert got["tile_floods"] == sum(st["floods"])
    for band_h in [None, 16, 8, 1]:
        out, got = k4.banded_stats(t, 10, 100, band_h=band_h)
        _, want, st = hysteresis_banded_skip(t, 10, 100, band_h=band_h)
        assert torch.equal(out, ref) and got["sweeps"] == want
        assert got["rounds_sum"] == sum(sum(r) for r in st["rounds"])
        assert got["rounds_max"] == max(max(r) for r in st["rounds"])


@pytest.mark.cuda
def test_engines_card_serpentine_vs_golden(cuda_device):
    nm = _snake(128, 256)
    ref = torch.from_numpy(golden.hysteresis(nm, 10, 100)).to(cuda_device)
    t = torch.from_numpy(nm).to(cuda_device)
    for tile in [(128, 512), (32, 128), (8, 32)]:
        assert torch.equal(k3.hysteresis_dilate(t, 10, 100, tile=tile), ref)
    for band_h in [None, 16, 1]:
        assert torch.equal(k4.hysteresis_banded(t, 10, 100, band_h=band_h), ref)


@pytest.mark.cuda
def test_engines_card_many_calls_one_shape(cuda_device):
    """200 calls in a row on one shape: flags and tokens are never cleared."""
    nms = [torch.from_numpy(_sparse_nm(96, 200, seed=s)).to(cuda_device)
           for s in range(4)]
    refs = [dilate.hysteresis_dilate(nm, 10, 100) for nm in nms]
    outs = []
    for i in range(200):
        fn = k3.hysteresis_dilate if i % 2 else k4.hysteresis_banded
        kw = {"tile": (16, 64)} if i % 2 else {"band_h": 8}
        outs.append((i, fn(nms[i % 4], 10, 100, **kw)))
    torch.cuda.synchronize()
    for i, out in outs:
        assert torch.equal(out, refs[i % 4]), i


@pytest.mark.cuda
def test_engines_card_two_shapes_alternating(cuda_device):
    """Two shapes and two configurations in turn: each finds its scratch."""
    a = torch.from_numpy(_rand_nm(64, 65, seed=1)).to(cuda_device)
    b = torch.from_numpy(_rand_nm(257, 333, seed=2)).to(cuda_device)
    for _ in range(5):
        for nm in (a, b):
            _card_check(nm, 30, 90)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,cases", [
    # K4, two words a lane: default bands of 250 and 200 rows (121 and 97 KB)
    ("banded", [((500, 1920), {}), ((400, 1920), {})]),
    # K4, four words a lane: 4096 and 3840 columns at the whole-image band
    ("banded", [((150, 4096), {}), ((150, 3840), {})]),
    # K4, two explicit bands on one shape (97 and 62 KB)
    ("banded", [((600, 1920), {"band_h": 200}), ((600, 1920), {"band_h": 128})]),
    # K3, two large tiles (102 and 80 KB)
    ("dilate", [((600, 2048), {"tile": (256, 1024)}),
                ((600, 2048), {"tile": (200, 1024)})]),
], ids=["banded-wpl2", "banded-wpl4", "banded-explicit", "dilate-tiles"])
def test_engines_card_alternating_shared_memory(cuda_device, engine, cases):
    """Two footprints above 48 KB in turn on one kernel: the larger one
    still launches after the smaller one has run."""
    kern, plain = ((k4.hysteresis_banded, banded.hysteresis_banded)
                   if engine == "banded" else
                   (k3.hysteresis_dilate, dilate.hysteresis_dilate))
    work = []
    for (h, w), kw in cases:
        nm = torch.from_numpy(_rand_nm(h, w, seed=h + w)).to(cuda_device)
        work.append((nm, kw, plain(nm, 30, 90, **kw)))
    for _ in range(3):
        for nm, kw, ref in work:
            assert torch.equal(kern(nm, 30, 90, **kw), ref), (nm.shape, kw)


@pytest.mark.cuda
def test_engines_card_other_stream(cuda_device):
    nm = torch.from_numpy(_sparse_nm(96, 200, seed=3)).to(cuda_device)
    ref = dilate.hysteresis_dilate(nm, 10, 100)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [k3.hysteresis_dilate(nm, 10, 100, tile=(16, 64)),
                k4.hysteresis_banded(nm, 10, 100, band_h=8)]
    side.synchronize()
    assert all(torch.equal(o, ref) for o in outs)


@pytest.mark.cuda
def test_engines_card_capacity(cuda_device):
    nm = torch.zeros((600, 8192), dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        k3.hysteresis_dilate(nm, 1, 2, tile=(600, 8192))
    with pytest.raises(ValueError, match="shared memory"):
        k4.hysteresis_banded(nm, 1, 2, band_h=600)
    # the default band (the whole image below 512 rows) is halved to fit
    tall = torch.from_numpy(_rand_nm(500, 1920, seed=9)).to(cuda_device)
    out, st = k4.banded_stats(tall, 30, 90)
    assert torch.equal(out, banded.hysteresis_banded(tall, 30, 90))
    assert st["band_h"] == 250
    # the widest image of the block-wide path, and one word a row past it:
    # the wide path (several words a thread), where K4 used to refuse
    wide = torch.from_numpy(_sparse_nm(40, 32768, seed=4)).to(cuda_device)
    _card_check(wide, 10, 100, tiles=[(128, 512)], bands=[None])
    wider = torch.from_numpy(_sparse_nm(8, 32800, seed=5)).to(cuda_device)
    before = k4.wide_launches
    _card_check(wider, 10, 100, tiles=[(128, 512)], bands=[None, 1])
    assert k4.wide_launches == before + 2
