"""Wrapper of K3, the tiled-dilation hysteresis engine
(``csrc/hysteresis_dilate.cu``; ``hysteresis_impl="dilate"``).

int16/int32 NMS magnitude ``(H, W)``, or a ``(B, H, W)`` batch, -> int16
{0, 255}.  A CPU tensor goes to the plain version
(:func:`..ops.dilate.hysteresis_dilate`, a frame at a time); a CUDA tensor
goes to the kernel or raises.  On the card a call is one cooperative
launch, for a batch too (JAX's ``vmap`` over its sweeps): the thresholds,
the packing, every sweep with its stop test and the unpacking run in the
kernel, and nothing is read back unless the caller asks for the sweep
count.  Also home of what K3's and K4's wrappers share (:func:`check_nm`,
:func:`plain_frames`, :func:`launch_engine`).
"""

from __future__ import annotations

import torch

from ..ops.dilate import DEFAULT_TILE, tile_shape
from ..ops.dilate import hysteresis_dilate as dilate_plain
from ..ops.thresholds import threshold_bound
from . import _build
from ._scratch import Scratch, buffer, next_token

# kernel launches made by this wrapper (the main path's proof of use): all,
# and those on a batch of two frames or more
launches = 0
batch_launches = 0

_scratch = Scratch()


def check_nm(nm: torch.Tensor) -> tuple[int, int, int]:
    """``(B, H, W)`` of a non-empty int16/int32 NMS map ``(H, W)`` (B = 1)
    or batch ``(B, H, W)``, or ValueError."""
    if nm.dtype not in (torch.int16, torch.int32) or nm.dim() not in (2, 3) \
            or nm.numel() == 0:
        raise ValueError(f"expected a non-empty int16/int32 (H, W) NMS map "
                         f"or (B, H, W) batch, got {nm.dtype} "
                         f"{tuple(nm.shape)}")
    if nm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nm.device}")
    return (nm.shape[0] if nm.dim() == 3 else 1), nm.shape[-2], nm.shape[-1]


def plain_frames(plain, nm, *args, **kw):
    """``plain(frame, *args, return_sweeps=True, **kw)`` on each frame of an
    NMS map or batch: ``(edges stacked as nm, the most sweeps of a
    frame)``."""
    if nm.dim() == 2:
        return plain(nm, *args, return_sweeps=True, **kw)
    outs, sweeps = zip(*(plain(f, *args, return_sweeps=True, **kw)
                         for f in nm))
    return torch.stack(outs), max(sweeps)


def launch_engine(name, scratch, nm, lo, hi, key, prepare):
    """One call of the C entry ``canny_<name>(nm, bytes, lo, hi, weak, e0,
    e1, out, B, H, W, *config, ctl, token, stream)`` of K3 or K4 on an NMS
    map or batch, on ``nm``'s device and PyTorch's current stream; ``lo``
    and ``hi`` are the integers of :func:`..ops.thresholds.threshold_bound`.

    The packed masks and the control words come from ``scratch``, per
    device, stream, ``(B, H, W)`` and ``key``; ``prepare(lib)`` runs once
    per entry, raises where the configuration does not fit the card, and
    returns ``(config, control words, *tensors)``: the tensors (buffers the
    configuration points to) live as long as the entry.  A repeated call
    costs one dictionary lookup, one ``torch.empty`` (the int16 output) and
    the launch.  Returns ``(out, entry)``: ``entry["config"]`` is the
    configuration run and ``entry["ints"]`` an int32 view of the counts the
    call leaves behind, which the next call on this entry overwrites.
    """
    if not nm.is_contiguous():
        nm = nm.contiguous()
    dev = nm.device
    b, h, w = check_nm(nm)
    with _build.device_guard(dev):
        stream = _build.stream_handle(dev)
        entry = scratch.lookup(dev, stream, (b, h, w, *key))
        if entry is None:
            lib = _build.load(f"hysteresis_{name}")
            config, words, *keep = prepare(lib)
            entry = scratch.create(dev, stream, (b, h, w, *key), words)
            entry["config"] = tuple(config)
            entry["keep"] = keep
            entry["ints"] = entry["ctl"][-2:].view(torch.int32)
            entry["fn"] = getattr(lib, f"canny_{name}")
            entry["ptrs"] = tuple(buffer(entry, m, b * h, w, dev).data_ptr()
                                  for m in ("weak", "e0", "e1"))
            entry["ctl_ptr"] = entry["ctl"].data_ptr()
        out = torch.empty(nm.shape, dtype=torch.int16, device=dev)
        err = entry["fn"](nm.data_ptr(), nm.element_size(), lo, hi,
                          *entry["ptrs"], out.data_ptr(), b, h, w,
                          *entry["config"], entry["ctl_ptr"], next_token(),
                          stream)
    _build.check(err, f"canny_{name} launch")
    return out, entry


def _run(nm, min_val, max_val, tile):
    """``(out, counts)``: ``counts`` holds the sweeps (CPU: a list) and, on
    the card, also the tile floods and block-wide flood rounds, as an int32
    device view that nothing has read yet."""
    global launches, batch_launches
    b, h, w = check_nm(nm)
    # the kernel and the plain version compare the same integers
    min_val, max_val = (threshold_bound(t, nm.dtype)
                        for t in (min_val, max_val))
    th, tw = tile_shape(h, w, tile)
    if nm.device.type == "cpu":
        out, sweeps = plain_frames(dilate_plain, nm, min_val, max_val,
                                   tile=tile)
        return out, [sweeps]

    def prepare(lib):
        need = lib.canny_dilate_smem_bytes(th, tw)
        limit = lib.canny_dilate_smem_limit()
        if need > limit:
            raise ValueError(f"tile {th}x{tw} needs {need} bytes of shared "
                             f"memory a block; this device allows {limit}")
        return (th, tw), lib.canny_dilate_scratch_words(b, h, w, th, tw)

    # seeds nm >= max(min_val, max_val): see ops/dilate.py
    out, entry = launch_engine("dilate", _scratch, nm, min_val,
                               max(min_val, max_val), (th, tw), prepare)
    launches += 1
    batch_launches += b > 1
    return out, entry["ints"]


def hysteresis_dilate(nm: torch.Tensor, min_val: int, max_val: int, *,
                      tile=DEFAULT_TILE, return_sweeps: bool = False):
    """Hysteresis by tiled dilation sweeps on ``nm``'s device.

    ``nm``: ``(H, W)`` or a batch ``(B, H, W)``, one launch on the card.
    ``tile``: the tile ``(th, tw)`` before the clamping of
    :func:`..ops.dilate.tile_shape`; it changes the sweep count, never the
    result.  ``return_sweeps``: also return the number of sweeps, of a
    batch the most of any frame (on the card that reads one word back, the
    call's only host sync).
    """
    out, counts = _run(nm, min_val, max_val, tile)
    return (out, int(counts[0])) if return_sweeps else out


def dilate_stats(nm: torch.Tensor, min_val: int, max_val: int, *,
                 tile=DEFAULT_TILE):
    """:func:`hysteresis_dilate` on one ``(H, W)`` map with the call's
    counts: ``(out, {"sweeps", "tile_floods", "flood_rounds"})``; on the CPU
    only ``sweeps``."""
    if nm.dim() != 2:
        raise ValueError(f"dilate_stats takes one (H, W) map, got "
                         f"{tuple(nm.shape)}")
    out, counts = _run(nm, min_val, max_val, tile)
    names = ("sweeps", "tile_floods", "flood_rounds")
    return out, dict(zip(names, list(counts) if isinstance(counts, list)
                         else counts.tolist()))
