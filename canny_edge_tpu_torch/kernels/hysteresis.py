"""Wrapper of K3, the tiled-dilation hysteresis engine
(``csrc/hysteresis_dilate.cu``; ``hysteresis_impl="dilate"``).

int16/int32 NMS magnitude ``(H, W)`` -> int16 {0, 255}.  A CPU tensor goes
to the plain version (:func:`..ops.dilate.hysteresis_dilate`); a CUDA
tensor goes to the kernel or raises.  On the card a call is one cooperative
launch: the thresholds, the packing, every sweep with its stop test and the
unpacking run in the kernel, and nothing is read back unless the caller
asks for the sweep count.  Also home of what K3's and K4's wrappers share
(:func:`check_nm`, :func:`launch_engine`).
"""

from __future__ import annotations

import torch

from ..ops.dilate import DEFAULT_TILE, tile_shape
from ..ops.dilate import hysteresis_dilate as dilate_plain
from . import _build
from ._scratch import Scratch, buffer, next_token

# kernel launches made by this wrapper (the main path's proof of use)
launches = 0

_scratch = Scratch()


def check_nm(nm: torch.Tensor) -> tuple[int, int]:
    """``(H, W)`` of a non-empty int16/int32 NMS map, or ValueError."""
    if nm.dtype not in (torch.int16, torch.int32) or nm.dim() != 2 \
            or nm.numel() == 0:
        raise ValueError(f"expected a non-empty int16/int32 (H, W) NMS map, "
                         f"got {nm.dtype} {tuple(nm.shape)}")
    if nm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nm.device}")
    return nm.shape[0], nm.shape[1]


def launch_engine(name, scratch, nm, lo, hi, key, prepare):
    """One call of the C entry ``canny_<name>(nm, bytes, lo, hi, weak, e0,
    e1, out, H, W, *config, ctl, token, stream)`` of K3 or K4, on ``nm``'s
    device and PyTorch's current stream.

    The packed masks and the control words come from ``scratch``, per
    device, stream, shape and ``key``; ``prepare(lib)`` runs once per entry,
    raises where the configuration does not fit the card, and returns
    ``(config, control words)``.  A repeated call costs one dictionary
    lookup, one ``torch.empty`` (the int16 output) and the launch.  Returns
    ``(out, entry)``: ``entry["config"]`` is the configuration run and
    ``entry["ints"]`` an int32 view of the counts the call leaves behind,
    which the next call on this entry overwrites.
    """
    if not nm.is_contiguous():
        nm = nm.contiguous()
    dev = nm.device
    h, w = nm.shape
    with _build.device_guard(dev):
        stream = _build.stream_handle(dev)
        entry = scratch.lookup(dev, stream, (h, w, *key))
        if entry is None:
            lib = _build.load(f"hysteresis_{name}")
            config, words = prepare(lib)
            entry = scratch.create(dev, stream, (h, w, *key), words)
            entry["config"] = tuple(config)
            entry["ints"] = entry["ctl"][-2:].view(torch.int32)
            entry["fn"] = getattr(lib, f"canny_{name}")
            entry["ptrs"] = tuple(buffer(entry, b, h, w, dev).data_ptr()
                                  for b in ("weak", "e0", "e1"))
            entry["ctl_ptr"] = entry["ctl"].data_ptr()
        out = torch.empty((h, w), dtype=torch.int16, device=dev)
        err = entry["fn"](nm.data_ptr(), nm.element_size(), int(lo), int(hi),
                          *entry["ptrs"], out.data_ptr(), h, w,
                          *entry["config"], entry["ctl_ptr"], next_token(),
                          stream)
    _build.check(err, f"canny_{name} launch")
    return out, entry


def _run(nm, min_val, max_val, tile):
    """``(out, counts)``: ``counts`` holds the sweeps (CPU: a list) and, on
    the card, also the tile floods and block-wide flood rounds, as an int32
    device view that nothing has read yet."""
    global launches
    h, w = check_nm(nm)
    th, tw = tile_shape(h, w, tile)
    if nm.device.type == "cpu":
        out, sweeps = dilate_plain(nm, min_val, max_val, tile=tile,
                                   return_sweeps=True)
        return out, [sweeps]

    def prepare(lib):
        need = lib.canny_dilate_smem_bytes(th, tw)
        limit = lib.canny_dilate_smem_limit()
        if need > limit:
            raise ValueError(f"tile {th}x{tw} needs {need} bytes of shared "
                             f"memory a block; this device allows {limit}")
        return (th, tw), lib.canny_dilate_scratch_words(h, w, th, tw)

    # seeds nm >= max(min_val, max_val): see ops/dilate.py
    out, entry = launch_engine("dilate", _scratch, nm, min_val,
                               max(int(min_val), int(max_val)), (th, tw),
                               prepare)
    launches += 1
    return out, entry["ints"]


def hysteresis_dilate(nm: torch.Tensor, min_val: int, max_val: int, *,
                      tile=DEFAULT_TILE, return_sweeps: bool = False):
    """Hysteresis by tiled dilation sweeps on ``nm``'s device.

    ``tile``: the tile ``(th, tw)`` before the clamping of
    :func:`..ops.dilate.tile_shape`; it changes the sweep count, never the
    result.  ``return_sweeps``: also return the number of sweeps (on the
    card that reads one word back, the call's only host sync).
    """
    out, counts = _run(nm, min_val, max_val, tile)
    return (out, int(counts[0])) if return_sweeps else out


def dilate_stats(nm: torch.Tensor, min_val: int, max_val: int, *,
                 tile=DEFAULT_TILE):
    """:func:`hysteresis_dilate` with the call's counts: ``(out, {"sweeps",
    "tile_floods", "flood_rounds"})``; on the CPU only ``sweeps``."""
    out, counts = _run(nm, min_val, max_val, tile)
    names = ("sweeps", "tile_floods", "flood_rounds")
    return out, dict(zip(names, list(counts) if isinstance(counts, list)
                         else counts.tolist()))
