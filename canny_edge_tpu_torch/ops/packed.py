"""Bit-packed masks and the plain packed hysteresis flood (K2's plain version).

Layout: ``(H, ceil(W/32))`` uint32, bit b of word j is column ``32*j + b``
(LSB = lowest column); width-padding bits are 0 and, carrying weak = 0,
never join an edge.

PyTorch has no ``>>``, ``<<`` or ``~`` for uint32 tensors, and int32 ``>>``
is arithmetic, so the flood computes on int64 tensors holding the word
values in ``[0, 2**32)``.  The words become ``torch.uint32`` only at the API
edge (:func:`to_words` / :func:`from_words`), through an int32 view; the
word helpers take either (:func:`_on_words`).

The flood is the one of ``canny_edge_tpu/ops/packed.py``: rounds of
``inner_dilate`` 8-connected dilations masked by the weak mask, then
segmented or-scan floods along rows and columns, until a round changes
nothing.  Dilation and floods are monotone and only add weak pixels
8-connected to an edge, so the fixed point is the set of weak pixels
connected to a strong one, whatever the round structure.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.constants import INNER_DILATE_XLA
from .thresholds import at_least

_M32 = 0xFFFFFFFF

# calls of the plain pack and unpack below, by name: a kernel path on the
# card must leave them unchanged
calls = {"pack_mask": 0, "unpack_mask": 0}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# word dtype at the API edge
# ---------------------------------------------------------------------------

def to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 word values in [0, 2**32) -> uint32 tensor (same device)."""
    signed = x - (x >= 2 ** 31).to(torch.int64) * 2 ** 32
    return signed.to(torch.int32).view(torch.uint32)


def from_words(u: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 word values in [0, 2**32)."""
    return u.view(torch.int32).to(torch.int64) & _M32


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool (..., H, W) -> uint32 (..., H, ceil(W/32)); pad bits are 0."""
    calls["pack_mask"] += 1
    w = mask.shape[-1]
    wd = cdiv(w, 32)
    m = mask.to(torch.int64)
    if wd * 32 != w:
        m = torch.nn.functional.pad(m, (0, wd * 32 - w))
    groups = m.reshape(*m.shape[:-1], wd, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return to_words((groups << shifts).sum(-1))


def unpack_mask(packed: torch.Tensor, w: int) -> torch.Tensor:
    """uint32 (..., H, Wd) -> bool (..., H, w)."""
    calls["unpack_mask"] += 1
    x = from_words(packed)
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (x[..., None] >> shifts) & 1
    flat = bits.reshape(*x.shape[:-1], x.shape[-1] * 32)
    return flat[..., :w] != 0


def unpack_edges(packed: torch.Tensor, w: int) -> torch.Tensor:
    """uint32 (..., H, Wd) -> int16 {0, 255} (..., H, w), on the same device."""
    return unpack_mask(packed, w).to(torch.int16) * 255


def unpack_edges_np(packed: np.ndarray, w: int) -> np.ndarray:
    """Host-side unpack: uint32 (..., H, Wd) -> int16 {0,255} (..., H, w)."""
    packed = np.asarray(packed, np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (packed[..., None] >> shifts) & np.uint32(1)
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32)
    return np.where(flat[..., :w] != 0, np.int16(255), np.int16(0))


# ---------------------------------------------------------------------------
# packed shifts over int64 word values
# ---------------------------------------------------------------------------
# The word helpers below (shl1 ... vflood) take JAX's words: uint32 tensors,
# as pack_mask makes them, in and out.  They compute on int64 word values,
# and take and return those too, which is what the port's own floods pass.

def _on_words(fn):
    """``fn`` on int64 word values, called with uint32 words: every uint32
    tensor argument goes in as int64 values and, if any did, the result
    comes back as uint32 words."""

    @functools.wraps(fn)
    def call(*args, **kw):
        words = [isinstance(a, torch.Tensor) and a.dtype == torch.uint32
                 for a in args]
        out = fn(*(from_words(a) if u else a for a, u in zip(args, words)),
                 **kw)
        return to_words(out) if any(words) else out

    return call


def _shift_words(e, k: int, axis: int):
    """Shift along ``axis`` by ``k`` (>0: toward higher index), zero fill."""
    n = e.shape[axis]
    out = torch.zeros_like(e)
    if abs(k) >= n:
        return out
    if k > 0:
        out.narrow(axis, k, n - k).copy_(e.narrow(axis, 0, n - k))
    else:
        out.narrow(axis, 0, n + k).copy_(e.narrow(axis, -k, n + k))
    return out


def _word_left(e, k: int = 1):
    """Word from ``k`` column blocks lower (zero fill)."""
    return _shift_words(e, k, -1)


def _word_right(e, k: int = 1):
    return _shift_words(e, -k, -1)


@_on_words
def shl1(e):
    """Shift the image one column toward higher column index (uint32 words
    in, uint32 out; int64 word values in, int64 out)."""
    return ((e << 1) & _M32) | (_word_left(e) >> 31)


@_on_words
def shr1(e):
    """Shift the image one column toward lower column index (uint32 words
    in, uint32 out; int64 word values in, int64 out)."""
    return (e >> 1) | ((_word_right(e) << 31) & _M32)


@_on_words
def dilate_packed(e, weak):
    """One 8-connected dilation step masked by weak (separable OR); uint32
    words in, uint32 out; int64 word values in, int64 out."""
    h = e | shl1(e) | shr1(e)
    return weak & (h | _shift_words(h, -1, -2) | _shift_words(h, 1, -2))


@_on_words
def strict_fix_packed(new, prev, weak, row0: int = 0, word0: int = 0):
    """Strict-reference correction of global pixel (0, 1) after a dilation.

    The reference BFS lacks the directed edge (1,0)->(0,1)
    (``src/utils.cpp:378,399``), so (0, 1) is re-derived from its allowed
    sources (0,0), (0,2), (1,1), (1,2) only.  The floods never move
    diagonally, so only dilations need this fix.  ``row0`` / ``word0``:
    where global row 0 and word 0 lie in the arrays (``(1, 1)`` on a block
    extended by a halo of one row and one word); a row below the arrays
    reads as 0.  Needs the image to have a pixel (0, 1).  uint32 words in,
    uint32 out; int64 word values in, int64 out.
    """
    p0 = prev[..., row0, word0]
    p1 = (prev[..., row0 + 1, word0] if row0 + 1 < prev.shape[-2]
          else torch.zeros_like(p0))
    allowed = ((p0 & 1) | ((p0 >> 2) & 1) | ((p1 >> 1) & 1)
               | ((p1 >> 2) & 1))
    val = ((p0 >> 1) & 1) | (((weak[..., row0, word0] >> 1) & 1) & allowed)
    out = new.clone()
    out[..., row0, word0] = (new[..., row0, word0] & (_M32 ^ 2)) | (val << 1)
    return out


# ---------------------------------------------------------------------------
# segmented or-scan floods (log-doubling transfer-function composition)
# ---------------------------------------------------------------------------
# Per pixel the one-step transfer is t(x) = a | (b & x) with a = "edge here",
# b = "weak here"; composition over a span doubles as
#   A' = A | (B & shift_s(A)),  B' = B & shift_s(B).

@_on_words
def hflood(e, weak, width: int):
    """Flood edges along entire horizontal weak runs (both directions);
    uint32 words in, uint32 out; int64 word values in, int64 out."""
    al, bl = e, weak
    ar, br = e, weak
    s = 1
    while s < min(32, width):
        cs = 32 - s
        al = al | (bl & (((al << s) & _M32) | (_word_left(al) >> cs)))
        bl = bl & (((bl << s) & _M32) | (_word_left(bl) >> cs))
        ar = ar | (br & ((ar >> s) | ((_word_right(ar) << cs) & _M32)))
        br = br & ((br >> s) | ((_word_right(br) << cs) & _M32))
        s *= 2
    wd = e.shape[-1]
    k = 1
    while k < wd:
        al = al | (bl & _word_left(al, k))
        bl = bl & _word_left(bl, k)
        ar = ar | (br & _word_right(ar, k))
        br = br & _word_right(br, k)
        k *= 2
    return e | (weak & (al | ar))


@_on_words
def vflood(e, weak, height: int):
    """Flood edges along entire vertical weak runs (both directions);
    uint32 words in, uint32 out; int64 word values in, int64 out."""
    au, bu = e, weak
    ad, bd = e, weak
    k = 1
    while k < height:
        au = au | (bu & _shift_words(au, -k, -2))
        bu = bu & _shift_words(bu, -k, -2)
        ad = ad | (bd & _shift_words(ad, k, -2))
        bd = bd & _shift_words(bd, k, -2)
        k *= 2
    return e | (weak & (au | ad))


# ---------------------------------------------------------------------------
# hysteresis
# ---------------------------------------------------------------------------

def hysteresis_packed_masks(weak_p, strong_p, height: int, width: int,
                            inner_dilate: int = INNER_DILATE_XLA,
                            strict: bool = False,
                            quirk_rw=(0, 0)):
    """Packed uint32 weak/strong masks -> (packed edge mask, rounds run).

    The plain version of the K2 kernel.  ``inner_dilate`` changes the
    number of rounds, never the result.  ``strict``: apply the
    strict-reference exclusion to every dilation (:func:`strict_fix_packed`)
    at ``quirk_rw``, the (row, word) of global pixel (0, 0) in the masks.
    """
    strict = strict and height >= 2 and width >= 2
    weak = from_words(weak_p)
    e = from_words(strong_p)

    def dil(x):
        d = dilate_packed(x, weak)
        return strict_fix_packed(d, x, weak, *quirk_rw) if strict else d

    rounds = 0
    while True:
        new = e
        for _ in range(inner_dilate):
            new = dil(new)
        new = vflood(hflood(new, weak, width), weak, height)
        rounds += 1
        if torch.equal(new, e):
            return to_words(e), rounds
        e = new


def hysteresis_packed(nm: torch.Tensor, min_val: int, max_val: int,
                      inner_dilate: int = INNER_DILATE_XLA,
                      strict: bool = False) -> torch.Tensor:
    """int NMS magnitude (..., H, W) -> int16 {0, 255}, on ``nm``'s device.

    The ``"packed-xla"`` engine and the ``xla`` backend's flood
    (``canny_edge_tpu/ops/packed.py:hysteresis_packed``): threshold, pack,
    the plain packed flood, unpack.  ``nm`` is compared signed (NOEDGE is 0,
    so ``min_val=0`` makes every pixel weak).  ``inner_dilate`` changes the
    number of rounds, never the result.
    """
    out, _ = hysteresis_packed_with_stats(nm, min_val, max_val, inner_dilate,
                                          strict=strict)
    return out


def hysteresis_packed_with_stats(nm: torch.Tensor, min_val: int,
                                 max_val: int,
                                 inner_dilate: int = INNER_DILATE_XLA,
                                 strict: bool = False):
    """:func:`hysteresis_packed` with the flood's rounds: ``(int16 {0, 255}
    edges, rounds)`` (``canny_edge_tpu/ops/packed.py:
    hysteresis_packed_with_stats``)."""
    h, w = nm.shape[-2], nm.shape[-1]
    edges, rounds = hysteresis_packed_masks(pack_mask(at_least(nm, min_val)),
                                            pack_mask(at_least(nm, max_val)),
                                            h, w,
                                            inner_dilate, strict=strict)
    return unpack_edges(edges, w), rounds
