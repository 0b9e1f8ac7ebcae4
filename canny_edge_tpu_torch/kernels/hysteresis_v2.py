"""Wrapper of K4, the banded raster-scan hysteresis engine
(``csrc/hysteresis_banded.cu``; ``hysteresis_impl="banded"``).

int16/int32 NMS magnitude ``(H, W)``, or a ``(B, H, W)`` batch, -> int16
{0, 255}.  A CPU tensor goes to the plain version
(:func:`..ops.banded.hysteresis_banded`, a frame at a time); a CUDA tensor
goes to the kernel or raises.  Any width: rows of up to 8192 columns run a
band a warp, up to 32768 a band a block, wider ones several words a thread
(:func:`k4_plan`).  On the card a call is one cooperative
launch, for a batch too (JAX's ``vmap`` over its sweeps): thresholds,
packing, sweeps with their ``needs_more`` test, unpacking; nothing is read
back unless the caller asks for the sweep count.
"""

from __future__ import annotations

import torch

from ..ops.banded import band_params
from ..ops.banded import hysteresis_banded as banded_plain
from ..ops.packed import cdiv
from ..ops.thresholds import threshold_bound
from ._scratch import Scratch
from .hysteresis import check_nm, launch_engine, plain_frames

# kernel launches made by this wrapper (the main path's proof of use): all,
# those on a batch of two frames or more, and those on rows wider than
# BLOCK_WORDS words (several words a thread)
launches = 0
batch_launches = 0
wide_launches = 0

_scratch = Scratch()

# words of a row each path takes (csrc/hysteresis_banded.cu): a band a warp
# up to 32 lanes x MAX_WPL 8 words, a band a block of BLOCK_THREADS 1024
# threads a word each up to 1024, beyond that several words a thread
WARP_WORDS = 256
BLOCK_WORDS = 1024


def smem_bytes(band_h: int, w: int) -> int:
    """Shared memory a block needs for one band of ``band_h`` rows of ``w``
    columns on the path of its width: the mirror of
    ``canny_banded_smem_bytes`` (two masks of ``band_h + 2`` rows; flag
    words on the warp and block-wide paths, a seed row on the wide one; the
    block scan's 384 static bytes past WARP_WORDS)."""
    wd, r = cdiv(w, 32), band_h + 2
    if wd <= BLOCK_WORDS:
        dyn = 2 * r * wd + 2 * cdiv(r, 32)
    else:
        dyn = 2 * r * wd + wd
    return 4 * dyn + (0 if wd <= WARP_WORDS else 3 * 32 * 4)


def k4_plan(w: int, band_h: int, asked: bool, smem_limit: int):
    """``(path, band_h)``: the path K4 takes for rows of ``w`` columns and
    the band it runs, on a card that gives a block ``smem_limit`` bytes.

    Paths: ``"warp"`` (a band a warp), ``"block"`` (a band a block, a word a
    thread), ``"wide"`` (several words a thread, the band in shared memory)
    and ``"wide-global"`` (the same, the band's rows in device memory).  A
    default band (not ``asked``) is halved while it does not fit; on the
    warp and block paths a band that still does not fit raises, past
    BLOCK_WORDS it runs from device memory at the band first chosen.
    """
    fit = band_h
    while not asked and fit > 1 and smem_bytes(fit, w) > smem_limit:
        fit = cdiv(fit, 2)
    wd = cdiv(w, 32)
    fits = smem_bytes(fit, w) <= smem_limit
    if wd > BLOCK_WORDS:
        return ("wide", fit) if fits else ("wide-global", band_h)
    if not fits:
        raise ValueError(f"a band of {fit} rows x {w} columns needs "
                         f"{smem_bytes(fit, w)} bytes of shared memory a "
                         f"block; this device allows {smem_limit}: pass a "
                         f"smaller band_h")
    return ("warp" if wd <= WARP_WORDS else "block"), fit


def _run(nm, min_val, max_val, band_h, group):
    """``(out, counts, band_h)``: ``counts`` holds the sweeps (CPU: a list)
    and, on the card, also the most rounds of a band in a sweep, the rounds
    summed and the bands run, as an int32 device view that nothing has read
    yet; ``band_h`` is the band that ran."""
    global launches, batch_launches, wide_launches
    b, h, w = check_nm(nm)
    # the kernel and the plain version compare the same integers
    min_val, max_val = (threshold_bound(t, nm.dtype)
                        for t in (min_val, max_val))
    asked = band_h is not None
    band_h, _ = band_params(h, w, band_h, group)
    if nm.device.type == "cpu":
        out, sweeps = plain_frames(banded_plain, nm, min_val, max_val,
                                   band_h=band_h)
        return out, [sweeps], band_h

    def prepare(lib):
        _, fit = k4_plan(w, band_h, asked, lib.canny_banded_smem_limit())
        words = lib.canny_banded_row_words(b, h, w, fit)
        if words < 0:
            raise ValueError(f"K4 cannot plan a call on {b} x {h} x {w} at "
                             f"band_h {fit}")
        # the band rows in device memory (none where the band fits)
        rows = torch.empty(max(words, 1), dtype=torch.int32, device=nm.device)
        return ((fit, rows.data_ptr(), words), lib.canny_banded_scratch_words(),
                rows)

    out, entry = launch_engine("banded", _scratch, nm, min_val, max_val,
                               (band_h, asked), prepare)
    launches += 1
    batch_launches += b > 1
    wide_launches += cdiv(w, 32) > BLOCK_WORDS
    return out, entry["ints"], entry["config"][0]


def hysteresis_banded(nm: torch.Tensor, min_val: int, max_val: int, *,
                      band_h=None, group=None, return_sweeps: bool = False):
    """Hysteresis by banded row recurrences on ``nm``'s device.

    ``nm``: ``(H, W)`` or a batch ``(B, H, W)``, one launch on the card,
    every frame cut into the same bands.
    ``band_h``/``group`` default and clamp as in the JAX engine
    (:func:`..ops.banded.band_params`); ``band_h`` changes the sweep count,
    never the result, and ``group`` (a TPU VMEM grouping) is only
    validated.  On the card a default band that does not fit a block's
    shared memory (below 512 rows JAX takes the whole image) is halved
    until it does; up to 32768 columns a ``band_h`` that was asked for and
    does not fit raises, above them a band that does not fit runs from
    device memory (:func:`k4_plan`): any width runs.
    ``return_sweeps``: also return the number of sweeps, of a batch the most
    of any frame (on the card that reads one word back, the call's only
    host sync).
    """
    out, counts, _ = _run(nm, min_val, max_val, band_h, group)
    return (out, int(counts[0])) if return_sweeps else out


def banded_stats(nm: torch.Tensor, min_val: int, max_val: int, *,
                 band_h=None, group=None):
    """:func:`hysteresis_banded` on one ``(H, W)`` map with the call's
    counts: ``(out, {"sweeps", "rounds_max", "rounds_sum", "bands_run",
    "band_h"})``, the rounds being those of a band in a sweep and ``band_h``
    the band that ran; on the CPU only ``sweeps`` and ``band_h``."""
    if nm.dim() != 2:
        raise ValueError(f"banded_stats takes one (H, W) map, got "
                         f"{tuple(nm.shape)}")
    out, counts, ran = _run(nm, min_val, max_val, band_h, group)
    names = ("sweeps", "rounds_max", "rounds_sum", "bands_run")
    stats = dict(zip(names, list(counts) if isinstance(counts, list)
                     else counts.tolist()))
    return out, {**stats, "band_h": ran}
