"""Wrapper of K3, the tiled-dilation hysteresis engine
(``csrc/hysteresis_dilate.cu``; ``hysteresis_impl="dilate"``).

int16/int32 NMS magnitude ``(H, W)`` -> int16 {0, 255}.  A CPU tensor goes
to the plain version (:func:`..ops.dilate.hysteresis_dilate`); a CUDA
tensor goes to the kernel or raises.  Also home of the host loop that K3
and K4 share (:func:`run_sweeps`).
"""

from __future__ import annotations

import torch

from ..ops.dilate import DEFAULT_TILE, tile_shape
from ..ops.dilate import hysteresis_dilate as dilate_plain
from ..ops.packed import cdiv
from . import _build

# kernel launches made by this wrapper (the main path's proof of use)
launches = 0


def check_nm(nm: torch.Tensor) -> tuple[int, int]:
    """``(H, W)`` of a non-empty int16/int32 NMS map, or ValueError."""
    if nm.dtype not in (torch.int16, torch.int32) or nm.dim() != 2 \
            or nm.numel() == 0:
        raise ValueError(f"expected a non-empty int16/int32 (H, W) NMS map, "
                         f"got {nm.dtype} {tuple(nm.shape)}")
    if nm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nm.device}")
    return nm.shape[0], nm.shape[1]


def run_sweeps(launch, device, first: int = 0) -> tuple[int, int]:
    """Drive sweeps until the first sweep ``i >= first`` whose flag stays 0.

    ``launch(i, flag_ptr)`` enqueues sweep ``i``, which sets the int32 at
    ``flag_ptr`` when another sweep is needed.  Sweeps go out in batches of
    ``first + 1`` sweeps, then twice as many each time, with one read-back
    of the batch's flags each, so a run of ``s`` sweeps costs about log2(s)
    host syncs and at most ``s`` extra sweeps, each of which changes
    nothing.  Returns ``(sweeps counted, sweeps launched)``.
    """
    done, batch = 0, first + 1
    while True:
        flags = torch.zeros(batch, dtype=torch.int32, device=device)
        for i in range(batch):
            launch(done + i, flags[i:].data_ptr())
        for i, f in enumerate(flags.tolist()):
            if not f and done + i >= first:
                return done + i + 1, done + batch
        done += batch
        batch *= 2


def hysteresis_dilate(nm: torch.Tensor, min_val: int, max_val: int, *,
                      tile=DEFAULT_TILE, return_sweeps: bool = False):
    """Hysteresis by tiled dilation sweeps on ``nm``'s device.

    ``tile``: the tile ``(th, tw)`` before the clamping of
    :func:`..ops.dilate.tile_shape`; it changes the sweep count, never the
    result.  ``return_sweeps``: also return the number of sweeps.
    """
    global launches
    h, w = check_nm(nm)
    th, tw = tile_shape(h, w, tile)
    if nm.device.type == "cpu":
        return dilate_plain(nm, min_val, max_val, tile=tile,
                            return_sweeps=return_sweeps)
    lib = _build.load("hysteresis_dilate")
    need = lib.canny_dilate_smem_bytes(th, tw)
    limit = lib.canny_dilate_smem_limit()
    if need > limit:
        raise ValueError(f"tile {th}x{tw} needs {need} bytes of shared memory "
                         f"a block; this device allows {limit}")
    nm = nm.contiguous()
    dev = nm.device
    weak = torch.empty((h, cdiv(w, 32)), dtype=torch.int32, device=dev)
    bufs = [torch.empty_like(weak), torch.zeros_like(weak)]
    out = torch.empty((h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # seeds nm >= max(min_val, max_val): see ops/dilate.py
        _build.check(lib.canny_dilate_pack(
            nm.data_ptr(), nm.element_size(), h, w, int(min_val),
            max(int(min_val), int(max_val)), weak.data_ptr(),
            bufs[0].data_ptr(), stream), "canny_dilate_pack launch")

        def sweep(i, flag):
            _build.check(lib.canny_dilate_sweep(
                weak.data_ptr(), bufs[i % 2].data_ptr(),
                bufs[(i + 1) % 2].data_ptr(), h, w, th, tw, flag, stream),
                "canny_dilate_sweep launch")

        # sweep 0's flag is not read: the JAX loop always runs sweep 1
        sweeps, launched = run_sweeps(sweep, dev, first=1)
        _build.check(lib.canny_dilate_unpack(
            bufs[launched % 2].data_ptr(), h, w, out.data_ptr(), stream),
            "canny_dilate_unpack launch")
    launches += 1
    return (out, sweeps) if return_sweeps else out
