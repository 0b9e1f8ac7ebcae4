"""Wrapper of K4, the banded raster-scan hysteresis engine
(``csrc/hysteresis_banded.cu``; ``hysteresis_impl="banded"``).

int16/int32 NMS magnitude ``(H, W)``, or a ``(B, H, W)`` batch, -> int16
{0, 255}.  A CPU tensor goes to the plain version
(:func:`..ops.banded.hysteresis_banded`, a frame at a time); a CUDA tensor
goes to the kernel or raises.  On the card a call is one cooperative
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
# and those on a batch of two frames or more
launches = 0
batch_launches = 0

_scratch = Scratch()


def _run(nm, min_val, max_val, band_h, group):
    """``(out, counts, band_h)``: ``counts`` holds the sweeps (CPU: a list)
    and, on the card, also the most rounds of a band in a sweep, the rounds
    summed and the bands run, as an int32 device view that nothing has read
    yet; ``band_h`` is the band that ran."""
    global launches, batch_launches
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
        if w > lib.canny_banded_max_width():
            raise ValueError(f"width {w} exceeds the kernel's maximum of "
                             f"{lib.canny_banded_max_width()}")
        fit, limit = band_h, lib.canny_banded_smem_limit()
        while (not asked and fit > 1
               and lib.canny_banded_smem_bytes(fit, w) > limit):
            fit = cdiv(fit, 2)
        need = lib.canny_banded_smem_bytes(fit, w)
        if need > limit:
            raise ValueError(f"a band of {fit} rows x {w} columns needs "
                             f"{need} bytes of shared memory a block; this "
                             f"device allows {limit}: pass a smaller band_h")
        return (fit,), lib.canny_banded_scratch_words()

    out, entry = launch_engine("banded", _scratch, nm, min_val, max_val,
                               (band_h, asked), prepare)
    launches += 1
    batch_launches += b > 1
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
    until it does; a ``band_h`` that was asked for and does not fit raises.
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
