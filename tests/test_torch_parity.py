"""PyTorch port: the name and signature guard.

Every public module-level name of every module of ``canny_edge_tpu`` has a
counterpart in the port's module of the same path (or at a path of
``MAPPED``), or stands in ``NO_COUNTERPART`` with its reason; every
parameter name of a public function or method of the JAX package is a
parameter of its counterpart, except those of ``PARAM_EXCEPTIONS``; and
ROADMAP.md §C's list of names with no counterpart names exactly the
entries of ``NO_COUNTERPART``.  The JAX package is read with ``ast`` (no
JAX module is imported for the walk, so nothing compiles); the port is
imported and read with ``inspect``.

Then the repairs the guard asked for, each against JAX where it computes
something: ``ops.xy_gradient(img=)``, ``exact_div_f32(a, b, iters=,
seed_recip=)``, ``ops.window.frontend_nm_xla`` (values and dtypes),
``ops.window.cdiv``, ``kernels.hysteresis_packed.
hysteresis_packed_pallas_masks`` (JAX's Pallas flood in interpret mode),
``utils.roofline``'s ``device_kind`` and ``vpu_ops`` keywords and the
package's ``golden``.  Tolerance: none (bit-equal, equal dtypes).
"""

import ast
import importlib
import inspect
import os
import re

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(ROOT, "canny_edge_tpu")

# (JAX module, name) -> the port's object it stands for, where the port
# names it otherwise
MAPPED = {
    ("kernels.hysteresis", "hysteresis_pallas"):
        "kernels.hysteresis.hysteresis_dilate",
    ("kernels.hysteresis_packed", "hysteresis_packed_pallas"):
        "kernels.hysteresis_packed.hysteresis_packed_nm",
    ("models", "CannyTPU"): "models.CannyTorch",
    ("models", "SobelTPU"): "models.SobelTorch",
    ("models.canny", "CannyTPU"): "models.canny.CannyTorch",
    ("models.sobel", "SobelTPU"): "models.sobel.SobelTorch",
    ("utils.roofline", "chip_vpu_ops"): "utils.roofline.chip_ops_per_s",
}

_NUMERICS = ("the TPU's division-free float32 helpers (a correctly rounded "
             "reciprocal and division by a vector, exact products by a "
             "constant, the divide by a near-one divisor, a float square "
             "root, angle bins in float32 and int32); on the card the IEEE "
             "`/`, eager products, `isqrt_int32` and `quantize_angle_int` "
             "do their jobs")
_ROOFLINE = ("TPU rates by chip generation with default rates, the rates "
             "measured on a TPU and the two-bucket floor built on them, and "
             "the stage tables; the port keys the H100's data-sheet peaks by "
             "card name (`PEAKS`), has no default and no measured rate, and "
             "builds a backend's stages in `backend_stages`")
_CONSTANTS = ("VMEM budgets and the VMEM flood's tuning; the port's "
              "`constants.py` reads the card's SMs, shared memory and L2")
_WINDOW = ("XLA front-end variants that fit XLA:TPU's fusion limits; K1 and "
           "the plain `frontend_nm` / `frontend_block` compute the same maps")

# (JAX module, name) -> why the port has no counterpart (TPU mechanics with
# no meaning on the card); ROADMAP.md §C lists the same names
NO_COUNTERPART = {
    ("kernels.frontend", "make_halo_tiles"):
        "cuts the image into overlapping VMEM tiles for a `BlockSpec`; K1 "
        "reads its own halo from device memory",
    ("kernels.hysteresis_packed", "flood_fits_vmem"):
        "whether a whole image's masks fit VMEM; K2 floods any size in "
        "tiles of 8 x 32 words",
    **{("ops.numerics", n): _NUMERICS for n in (
        "exact_recip_f32", "exact_div_by_vector", "mul_const_f32",
        "exact_mul_const_f32", "near_one_ulp_offset", "div_by_near_one",
        "isqrt_f32", "nms_bin_masks_f32", "quantize_angle_i32")},
    **{("ops.window", n): _WINDOW for n in (
        "window_nm", "window_nm_interior", "frontend_nm_static",
        "frontend_nm_strips", "frontend_nm_banded")},
    **{("utils.constants", n): _CONSTANTS for n in (
        "TPU_VMEM_BYTES", "DEFAULT_VMEM_BYTES", "MIB", "vmem_bytes",
        "frontend_vmem_budget", "kernel_vmem_limit", "INNER_DILATE_VMEM",
        "FLOOD_LIVE_WORD_ARRAYS")},
    **{("utils.opcount", n): "read XLA HLO text; the port audits the plain "
       "versions under a dispatch mode"
       for n in ("audit_hlo_text", "hbm_materialization_bytes")},
    **{("utils.roofline", n): _ROOFLINE for n in (
        "HBM_BW_GBPS", "DEFAULT_BW", "VPU_OPS_PER_S", "DEFAULT_VPU",
        "MEASURED_ELEM_RATES", "chip_elem_rates", "two_bucket_floor_seconds",
        "XLA_STAGES", "PALLAS_STAGES", "FUSED_STAGES", "STAGES_BY_BACKEND")},
}

# (JAX module, function, parameter) -> why the counterpart lacks it
PARAM_EXCEPTIONS = {
    **{(m, f, "interpret"): "Pallas' interpreter: a CPU tensor takes the "
       "plain version, a CUDA tensor the kernel"
       for m, f in (("kernels.fused", "canny_fused"),
                    ("kernels.hysteresis", "hysteresis_pallas"),
                    ("kernels.hysteresis_packed", "hysteresis_packed_pallas"),
                    ("kernels.hysteresis_v2", "hysteresis_banded"))},
    **{("parallel.halo", f, "x"): "a `shard_map` array: the port takes the "
       "block dicts and the mesh in its place"
       for f in ("halo_exchange_cols", "halo_exchange_rows",
                 "halo_exchange_2d")},
}


def _jax_modules():
    """Dotted paths of the JAX package's modules ("" for the package)."""
    mods = []
    for dirpath, dirnames, files in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT)
                parts = rel[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                mods.append(".".join(parts))
    return sorted(mods)


def _jax_public(mod):
    """``{name: ast node or None}``: the public names the module defines
    (functions, classes, assignments) and, for a package, those its
    ``__init__`` imports (None: checked where they are defined)."""
    path = os.path.join(JAX_ROOT, *mod.split(".")) if mod else JAX_ROOT
    init = os.path.isdir(path)
    path = os.path.join(path, "__init__.py") if init else path + ".py"
    names = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = node
        elif isinstance(node, ast.Assign):
            names.update({t.id: None for t in node.targets
                          if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names[node.target.id] = None
        elif init and isinstance(node, ast.ImportFrom):
            names.update({a.asname or a.name: None for a in node.names})
    return {k: v for k, v in names.items() if not k.startswith("_")}


def _port(path):
    mod, _, name = f"canny_edge_tpu_torch.{path}".rpartition(".")
    return getattr(importlib.import_module(mod), name)


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef):
    return any(isinstance(d, ast.Name) and d.id == "property"
               or isinstance(d, ast.Attribute) and d.attr in ("setter",
                                                              "getter")
               for d in fn.decorator_list)


def _missing_params(mod, qual, fn, obj):
    """``fn``'s parameter names that ``obj`` lacks, less the exceptions."""
    have = set(inspect.signature(obj).parameters)
    return [p for p in _params(fn) if p not in have
            and (mod, qual, p) not in PARAM_EXCEPTIONS]


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_name_and_parameter_has_its_counterpart(mod):
    port = importlib.import_module(
        "canny_edge_tpu_torch" + (f".{mod}" if mod else ""))
    faults = []
    for name, node in _jax_public(mod).items():
        if (mod, name) in NO_COUNTERPART:
            assert not hasattr(port, name), \
                f"{mod}:{name} is listed as having no counterpart, has one"
            continue
        path = MAPPED.get((mod, name))
        if path is None and not hasattr(port, name):
            faults.append(f"{mod}:{name} has no counterpart")
            continue
        obj = getattr(port, name) if path is None else _port(path)
        if isinstance(node, ast.FunctionDef):
            miss = _missing_params(mod, name, node, obj)
            faults += [f"{mod}:{name} lacks {miss}"] if miss else []
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if not isinstance(m, ast.FunctionDef) or (
                        m.name.startswith("_") and m.name != "__init__"):
                    continue
                qual = f"{name}.{m.name}"
                if not hasattr(obj, m.name):
                    faults.append(f"{mod}:{qual} has no counterpart")
                elif not _is_property(m):
                    miss = _missing_params(mod, qual, m,
                                           getattr(obj, m.name))
                    faults += [f"{mod}:{qual} lacks {miss}"] if miss else []
    assert not faults, faults


def test_tables_name_jax_names():
    """Every table entry names a public name, function or parameter of
    the JAX package, so that no entry outlives what it excuses."""
    for mod, name in list(NO_COUNTERPART) + list(MAPPED):
        assert name in _jax_public(mod), f"{mod}:{name}"
    for mod, qual, param in PARAM_EXCEPTIONS:
        node = _jax_public(mod)[qual]
        assert param in _params(node), f"{mod}:{qual}({param})"
    for path in MAPPED.values():
        _port(path)


def _roadmap_no_counterpart():
    """``{(module, name)}`` of ROADMAP.md §C's list of names with no
    counterpart: bullets ``- `path/module.py`: `name`, `name`: reason``."""
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    start = text.index("Names of the JAX package that get no counterpart")
    block = text[start:].split("\n\n", 1)[0]
    found = set()
    for bullet in re.split(r"\n- ", block)[1:]:
        m = re.match(r"`([\w/]+)\.py`: (.*?): ", " ".join(bullet.split()))
        if m is None:
            continue
        mod = m.group(1).replace("/", ".")
        found |= {(mod, n) for n in re.findall(r"`(\w+)`", m.group(2))}
    return found


def test_roadmap_lists_exactly_the_table():
    assert _roadmap_no_counterpart() == set(NO_COUNTERPART)


# ---------------------------------------------------------------------------
# the repairs, against JAX
# ---------------------------------------------------------------------------

def _frame(h=40, w=70, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def test_xy_gradient_takes_img():
    from canny_edge_tpu.ops import xy_gradient as jax_xy
    from canny_edge_tpu_torch.ops import xy_gradient

    sm = np.random.default_rng(4).integers(0, 256, (2, 17, 33), np.int16)
    got = xy_gradient(img=torch.from_numpy(sm))
    want = jax_xy(img=sm)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_exact_div_f32_takes_jax_keywords():
    from canny_edge_tpu.ops.numerics import exact_div_f32 as jax_div
    from canny_edge_tpu_torch.ops.numerics import exact_div_f32

    rng = np.random.default_rng(5)
    a = (rng.random(1000) * 1e4).astype(np.float32)
    b = (rng.random(1000) * 100 + 0.5).astype(np.float32)
    want = np.asarray(jax_div(a, b, iters=6))
    for kw in ({}, {"iters": 6}, {"iters": 3, "seed_recip": None}):
        got = exact_div_f32(torch.from_numpy(a), torch.from_numpy(b), **kw)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("thresholds", [None, (20, 60)])
def test_frontend_nm_xla_equals_jax(thresholds):
    from canny_edge_tpu.golden.reference import gaussian_kernel
    from canny_edge_tpu.ops.window import frontend_nm_xla as jax_fe
    from canny_edge_tpu_torch.ops.window import frontend_nm_xla

    img = _frame()
    kv = tuple(float(v) for v in gaussian_kernel(1.4))
    want = jax_fe(img, kv, thresholds=thresholds)
    got = frontend_nm_xla(torch.from_numpy(img), kv, whole_h=1440,
                          band_h=720, thresholds=thresholds)
    pairs = [(got, want)] if thresholds is None else list(zip(got, want))
    for g, w in pairs:
        w = np.asarray(w)
        assert g.dtype == getattr(torch, w.dtype.name)
        np.testing.assert_array_equal(g.numpy(), w)


def test_cdiv_in_ops_window():
    from canny_edge_tpu.ops.window import cdiv as jax_cdiv
    from canny_edge_tpu_torch.ops.window import cdiv

    for a, b in ((0, 32), (1, 32), (32, 32), (33, 32), (1921, 64), (7, 1)):
        assert cdiv(a, b) == jax_cdiv(a, b)


@pytest.mark.parametrize("strict,quirk_rw", [(False, (0, 0)),
                                             (True, (1, 1))])
def test_hysteresis_packed_pallas_masks_equals_jax(strict, quirk_rw):
    """JAX's Pallas flood (interpret mode) against the port's function of
    the same name on a random map whose masks span several words."""
    import jax.numpy as jnp

    from canny_edge_tpu.kernels.hysteresis_packed import \
        hysteresis_packed_pallas_masks as jax_flood
    from canny_edge_tpu.ops.packed import pack_mask as jax_pack
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.ops.packed import pack_mask

    rng = np.random.default_rng(6)
    h, w = 24, 100
    nm = rng.integers(0, 100, (h, w)).astype(np.int32)
    nm[rng.random((h, w)) < 0.45] = 0
    want = np.asarray(jax_flood(jax_pack(jnp.asarray(nm >= 30)),
                                jax_pack(jnp.asarray(nm >= 90)), h, w,
                                strict=strict, quirk_rw=quirk_rw))
    weak = pack_mask(torch.from_numpy(nm >= 30))
    strong = pack_mask(torch.from_numpy(nm >= 90))
    before = khp.launches
    got = khp.hysteresis_packed_pallas_masks(
        weak, strong, h, w, inner_dilate=19, interpret=None,
        layout="transposed", vmem_budget=None, strict=strict,
        quirk_rw=quirk_rw)
    assert khp.launches == before       # a CPU tensor: the plain flood
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(np.int32))


def test_roofline_takes_jax_keywords():
    from canny_edge_tpu_torch.utils import roofline

    card = roofline.H100_SXM
    secs = {"frontend": 1e-3, "hysteresis": 5e-4}
    assert roofline.stage_rooflines(2_073_600, secs, device_kind=card) \
        == roofline.stage_rooflines(2_073_600, secs, card)
    assert roofline.report(2_073_600, secs, device_kind=card) \
        == roofline.report(2_073_600, secs, card)
    assert roofline.chip_bandwidth_gbps(device_kind=card) == 3350.0
    assert roofline.chip_ops_per_s(device_kind=card) == 33.5e12
    st = roofline.StageTraffic("x", 1.0, 100.0)
    assert st.compute_seconds(10, vpu_ops=1e3) == 1.0


def test_package_exports_golden():
    import canny_edge_tpu_torch

    assert canny_edge_tpu_torch.golden.canny is not None
    assert canny_edge_tpu_torch.golden.__name__ == "canny_edge_tpu_torch.golden"


@pytest.fixture
def cuda_device():
    """The card, for the kernel tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_pallas_masks_launches_k2(cuda_device):
    from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
    from canny_edge_tpu_torch.ops import packed as P

    rng = np.random.default_rng(7)
    nm = torch.from_numpy(rng.integers(0, 100, (70, 333))).to(cuda_device)
    weak, strong = P.pack_mask(nm >= 30), P.pack_mask(nm >= 90)
    before = khp.launches
    got = khp.hysteresis_packed_pallas_masks(weak, strong, 70, 333,
                                             strict=True, quirk_rw=(2, 3))
    torch.cuda.synchronize()
    assert khp.launches == before + 1
    want, _ = P.hysteresis_packed_masks(weak, strong, 70, 333, strict=True,
                                        quirk_rw=(2, 3))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
