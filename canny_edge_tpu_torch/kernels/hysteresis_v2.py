"""Wrapper of K4, the banded raster-scan hysteresis engine
(``csrc/hysteresis_banded.cu``; ``hysteresis_impl="banded"``).

int16/int32 NMS magnitude ``(H, W)`` -> int16 {0, 255}.  A CPU tensor goes
to the plain version (:func:`..ops.banded.hysteresis_banded`); a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.banded import band_params
from ..ops.banded import hysteresis_banded as banded_plain
from ..ops.packed import cdiv
from . import _build
from .hysteresis import check_nm, run_sweeps

# kernel launches made by this wrapper (the main path's proof of use)
launches = 0


def hysteresis_banded(nm: torch.Tensor, min_val: int, max_val: int, *,
                      band_h=None, group=None, return_sweeps: bool = False):
    """Hysteresis by banded row recurrences on ``nm``'s device.

    ``band_h``/``group`` default and clamp as in the JAX engine
    (:func:`..ops.banded.band_params`); ``band_h`` changes the sweep count,
    never the result, and ``group`` (a TPU VMEM grouping) is only
    validated.  On the card a default band that does not fit a block's
    shared memory (below 512 rows JAX takes the whole image) is halved
    until it does; a ``band_h`` that was asked for and does not fit raises.
    ``return_sweeps``: also return the number of sweeps.
    """
    global launches
    h, w = check_nm(nm)
    asked = band_h is not None
    band_h, _ = band_params(h, w, band_h, group)
    if nm.device.type == "cpu":
        return banded_plain(nm, min_val, max_val, band_h=band_h,
                            return_sweeps=return_sweeps)
    lib = _build.load("hysteresis_banded")
    if w > lib.canny_banded_max_width():
        raise ValueError(f"width {w} exceeds the kernel's maximum of "
                         f"{lib.canny_banded_max_width()}")
    limit = lib.canny_banded_smem_limit()
    while (not asked and band_h > 1
           and lib.canny_banded_smem_bytes(band_h, w) > limit):
        band_h = cdiv(band_h, 2)
    need = lib.canny_banded_smem_bytes(band_h, w)
    if need > limit:
        raise ValueError(f"a band of {band_h} rows x {w} columns needs {need} "
                         f"bytes of shared memory a block; this device allows "
                         f"{limit}: pass a smaller band_h")
    nm = nm.contiguous()
    dev = nm.device
    weak = torch.empty((h, cdiv(w, 32)), dtype=torch.int32, device=dev)
    bufs = [torch.empty_like(weak), torch.empty_like(weak)]
    out = torch.empty((h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.canny_banded_pack(
            nm.data_ptr(), nm.element_size(), h, w, int(min_val),
            int(max_val), weak.data_ptr(), bufs[0].data_ptr(), stream),
            "canny_banded_pack launch")

        def sweep(i, flag):
            _build.check(lib.canny_banded_sweep(
                weak.data_ptr(), bufs[i % 2].data_ptr(),
                bufs[(i + 1) % 2].data_ptr(), h, w, band_h, flag, stream),
                "canny_banded_sweep launch")

        sweeps, launched = run_sweeps(sweep, dev)
        _build.check(lib.canny_banded_unpack(
            bufs[launched % 2].data_ptr(), h, w, out.data_ptr(), stream),
            "canny_banded_unpack launch")
    launches += 1
    return (out, sweeps) if return_sweeps else out
