"""PyTorch port, the call walk beside the name walk of ``test_torch_parity``:
every public function of the JAX package's ``ops/packed.py``,
``ops/shifts.py`` and ``ops/stages.py`` called with seeded NumPy inputs in
JAX's own types (uint32 words where JAX takes words, uint8 frames, int16
blurs, int32 maps, bool masks), and its counterpart in the port called with
the same values in the same types.  Values, dtypes and shapes must agree,
with no tolerance.  A 0-d integer array of JAX and a Python int of the port
are the same count (the floods' rounds and steps).

The word helpers run at a width that is not a multiple of 32, and
``strict_fix_packed`` at a nonzero ``(row0, word0)`` too.
"""

import ast
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: a worker's share)

from canny_edge_tpu.ops import packed as JP
from canny_edge_tpu.ops import shifts as JS
from canny_edge_tpu.ops import stages as JG
from canny_edge_tpu_torch.ops import packed as PP
from canny_edge_tpu_torch.ops import shifts as PS
from canny_edge_tpu_torch.ops import stages as PG

H, W = 37, 70                      # W: two words and 6 bits
RNG = np.random.default_rng(20261017)
IMG = RNG.integers(0, 256, (H, W), dtype=np.uint8)
NM = np.where(RNG.random((H, W)) < 0.5, RNG.integers(0, 160, (H, W)),
              0).astype(np.int32)
WEAK = RNG.random((H, W)) < 0.6
STRONG = WEAK & (RNG.random((H, W)) < 0.05)
I32 = RNG.integers(-1000, 1000, (H, W), dtype=np.int32)
BOOLS = RNG.random((H, W)) < 0.5


def _words(mask):
    return np.asarray(JP.pack_mask(jnp.asarray(mask)))


WEAK_W, STRONG_W = _words(WEAK), _words(STRONG)
BLUR = np.asarray(JG.gaussian_blur(jnp.asarray(IMG), 1.4))
MAG, ANG = (np.asarray(a) for a in JG.sobel(jnp.asarray(BLUR)))


def _jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _port(x):
    return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want, where):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
        return
    if isinstance(got, int) and not isinstance(got, bool):
        w = np.asarray(want)
        assert w.shape == () and np.issubdtype(w.dtype, np.integer), where
        assert got == int(w), f"{where}: {got} != {int(w)}"
        return
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, f"{where}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{where}: shape {g.shape} != {w.shape}"
    assert np.array_equal(g, w), (
        f"{where}: {int(np.sum(g != w))} values differ")


# name -> list of (args, kwargs): the same NumPy values go to both
CALLS = {
    "packed": {
        "cdiv": [((7, 3), {}), ((64, 32), {}), ((1, 32), {})],
        "pack_mask": [((WEAK,), {}), ((BOOLS[:, :33],), {})],
        "unpack_mask": [((WEAK_W, W), {}), ((WEAK_W, 65), {})],
        "unpack_edges_np": [((WEAK_W, W), {})],
        "shl1": [((WEAK_W,), {}), ((STRONG_W,), {})],
        "shr1": [((WEAK_W,), {}), ((STRONG_W,), {})],
        "dilate_packed": [((STRONG_W, WEAK_W), {})],
        "strict_fix_packed": [((_words(WEAK & ~STRONG), STRONG_W, WEAK_W), {}),
                              ((WEAK_W, STRONG_W, WEAK_W, 1, 1), {}),
                              ((WEAK_W, STRONG_W, WEAK_W), {"row0": 3,
                                                            "word0": 2})],
        "hflood": [((STRONG_W, WEAK_W, W), {})],
        "vflood": [((STRONG_W, WEAK_W, H), {})],
        "hysteresis_packed_masks": [
            ((WEAK_W, STRONG_W, H, W), {}),
            ((WEAK_W, STRONG_W, H, W), {"strict": True}),
            ((WEAK_W, STRONG_W, H, W), {"inner_dilate": 1, "strict": True,
                                        "quirk_rw": (1, 1)})],
        "hysteresis_packed": [((NM, 30, 90), {}),
                              ((NM, 30, 90), {"strict": True})],
        "hysteresis_packed_with_stats": [((NM, 30, 90), {}),
                                         ((NM, 0, 120), {"inner_dilate": 2})],
    },
    "shifts": {
        "shift_cols": [((I32, 1), {}), ((I32, -3, 7), {}), ((BOOLS, 2), {}),
                       ((I32, 0), {}), ((I32, W + 1, -5), {})],
        "shift_rows": [((I32, 1), {}), ((I32, -3, 7), {}), ((BOOLS, -2), {}),
                       ((I32, H), {})],
        "shift2d": [((I32, 1, -1), {}), ((I32, -2, 3, -32768), {}),
                    ((BOOLS, 1, 1), {})],
        "clamp_shift_cols": [((I32, 1), {}), ((BLUR, -1), {})],
        "clamp_shift_rows": [((I32, -1), {}), ((BLUR, 1), {})],
    },
    "stages": {
        "gaussian_blur": [((IMG, 1.4), {}), ((IMG[:20, :33], 0.5), {})],
        "xy_gradient": [((BLUR,), {})],
        "sobel": [((BLUR,), {})],
        "nonmax_suppression": [((MAG, ANG), {})],
        "hysteresis": [((NM, 30, 90), {}),
                       ((NM, 30, 90, 2, "strict-reference"), {})],
        "hysteresis_with_stats": [((NM, 30, 90), {}),
                                  ((NM, 10, 60), {"steps_per_check": 1})],
    },
}
JAX_MODULES = {"packed": JP, "shifts": JS, "stages": JG}
PORT_MODULES = {"packed": PP, "shifts": PS, "stages": PG}


def _public_functions(module):
    """The functions a JAX module defines at its top level, by ``ast``."""
    tree = ast.parse(Path(inspect.getfile(module)).read_text())
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


@pytest.mark.parametrize("mod", sorted(CALLS))
def test_every_public_function_is_called(mod):
    assert set(CALLS[mod]) == _public_functions(JAX_MODULES[mod])


CASES = [(mod, name, i) for mod in sorted(CALLS)
         for name in sorted(CALLS[mod]) for i in range(len(CALLS[mod][name]))]


@pytest.mark.parametrize("mod,name,i", CASES,
                         ids=[f"{m}.{n}-{i}" for m, n, i in CASES])
def test_call_equals_jax(mod, name, i):
    args, kw = CALLS[mod][name][i]
    jfn = getattr(JAX_MODULES[mod], name)
    pfn = getattr(PORT_MODULES[mod], name)
    if name == "unpack_edges_np":      # a host function: NumPy in, out
        want, got = jfn(*args, **kw), pfn(*args, **kw)
    else:
        want = jfn(*(_jax(a) for a in args), **kw)
        got = pfn(*(_port(a) for a in args), **kw)
    _same(got, want, f"{mod}.{name} call {i}")


@pytest.mark.parametrize("name", ["shl1", "shr1", "dilate_packed",
                                  "strict_fix_packed", "hflood", "vflood"])
def test_word_helpers_take_either_word_form(name):
    """uint32 words in, uint32 out (JAX's form); the port's int64 word
    values in, int64 out, equal to the same words."""
    args = {"shl1": (WEAK_W,), "shr1": (WEAK_W,),
            "dilate_packed": (STRONG_W, WEAK_W),
            "strict_fix_packed": (WEAK_W, STRONG_W, WEAK_W, 1, 1),
            "hflood": (STRONG_W, WEAK_W, W),
            "vflood": (STRONG_W, WEAK_W, H)}[name]
    fn = getattr(PP, name)
    words = fn(*(_port(a) for a in args))
    values = fn(*(PP.from_words(_port(a)) if isinstance(a, np.ndarray)
                  else a for a in args))
    assert words.dtype == torch.uint32 and values.dtype == torch.int64
    assert torch.equal(PP.from_words(words), values)
