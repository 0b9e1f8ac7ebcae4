"""Wrapper of K2, the packed hysteresis flood (``csrc/hysteresis_packed.cu``).

Two inputs and two outputs, every combination one kernel call on the card:

* :func:`hysteresis_packed`: packed uint32 weak/strong masks
  ``(H, ceil(W/32))`` -> the packed edge mask, or with ``edges_int16=True``
  the int16 ``{0, 255}`` edge map ``(H, W)``;
* :func:`hysteresis_packed_nm`: an int16/int32 NMS map with the two
  thresholds (``hysteresis_impl="packed"``) -> the int16 edge map, or with
  ``packed_out=True`` the packed edge mask.

A CPU tensor goes to the plain version, composed of
:mod:`..ops.packed`'s ``pack_mask``, ``hysteresis_packed_masks`` and
``unpack_edges``; a CUDA tensor goes to the kernel, for every shape from 1x1
up, or raises.  On the card the thresholds, the packing and the unpacking
run in the kernel's own file, never in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..ops.packed import cdiv, hysteresis_packed_masks, pack_mask, unpack_edges
from . import _build
from ._scratch import Scratch, buffer, next_token

# kernel launches made by this wrapper (the main path's proof of use)
launches = 0

_scratch = Scratch()


def _launch(dev, h, w, *, weak=None, strong=None, nm=None, lo=0, hi=0,
            int16_out, strict):
    """One call of the kernel; returns ``(output, steps)`` with ``steps`` a
    0-d view of the scratch that the next call on this shape overwrites."""
    global launches
    lib = _build.load("hysteresis_packed")
    with _build.device_guard(dev):
        stream = _build.stream_handle(dev)
        entry = _scratch.lookup(dev, stream, (h, w))
        if entry is None:
            entry = _scratch.create(
                dev, stream, (h, w),
                lib.canny_hysteresis_packed_scratch_words(h, w))
        if nm is not None:
            weak = buffer(entry, "weak", h, w, dev)
            strong = buffer(entry, "strong", h, w, dev)
        if int16_out:
            out = torch.empty((h, w), dtype=torch.int16, device=dev)
            edges = buffer(entry, "edges", h, w, dev)
        else:
            out = edges = torch.empty((h, cdiv(w, 32)), dtype=torch.uint32,
                                      device=dev)
        err = lib.canny_hysteresis_packed(
            weak.data_ptr(), strong.data_ptr(),
            None if nm is None else nm.data_ptr(),
            0 if nm is None else nm.element_size(), int(lo), int(hi),
            edges.data_ptr(), out.data_ptr() if int16_out else None, h, w,
            int(bool(strict)), entry["ctl"].data_ptr(), next_token(),
            stream)
    _build.check(err, "canny_hysteresis_packed launch")
    launches += 1
    return out, entry["ctl"][-1]


def hysteresis_packed(weak: torch.Tensor, strong: torch.Tensor, height: int,
                      width: int, *, strict: bool = False,
                      return_steps: bool = False, edges_int16: bool = False):
    """Flood ``weak`` from ``strong`` to the fixed point.

    ``strict``: the strict-reference exclusion of the promotion
    (1,0) -> (0,1).  ``edges_int16``: return the int16 {0, 255} edge map
    ``(height, width)`` instead of the packed mask.  ``return_steps``: also
    return the number of flood steps (kernel: grid-wide steps, a 0-d device
    tensor; CPU: the plain version's rounds).
    """
    shape = (height, cdiv(width, 32))
    for name, t in (("weak", weak), ("strong", strong)):
        if t.dtype != torch.uint32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be uint32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if height < 1 or width < 1:
        raise ValueError(f"empty image {height}x{width}")
    if weak.device != strong.device:
        raise ValueError("weak and strong lie on different devices")
    if weak.device.type == "cpu":
        out, steps = hysteresis_packed_masks(weak, strong, height, width,
                                             strict=strict)
        if edges_int16:
            out = unpack_edges(out, width)
    elif weak.device.type == "cuda":
        out, steps = _launch(
            weak.device, height, width, weak=weak.contiguous(),
            strong=strong.contiguous(), int16_out=edges_int16, strict=strict)
        if return_steps:
            steps = steps.clone()
    else:
        raise ValueError(f"unsupported device {weak.device}")
    return (out, steps) if return_steps else out


def hysteresis_packed_nm(nm: torch.Tensor, min_val: int, max_val: int, *,
                         strict: bool = False, packed_out: bool = False,
                         return_steps: bool = False):
    """int16/int32 NMS magnitude (H, W) or (B, H, W) -> int16 {0, 255}.

    The counterpart of ``canny_edge_tpu/kernels/hysteresis_packed.py:
    hysteresis_packed_pallas``.  ``weak = nm >= min_val`` and ``strong = nm
    >= max_val``, compared signed.  On the card the compares, the packing,
    the flood and the unpacking are one kernel call a frame; on the CPU they
    are the plain versions.  ``packed_out``: return the packed uint32 edge
    mask instead.  ``return_steps`` (single frame only): as in
    :func:`hysteresis_packed`.
    """
    if nm.dim() == 3:
        if return_steps:
            raise ValueError("return_steps takes one frame")
        return torch.stack([
            hysteresis_packed_nm(f, min_val, max_val, strict=strict,
                                 packed_out=packed_out)
            for f in nm])
    if nm.dim() != 2 or nm.numel() == 0 \
            or nm.dtype not in (torch.int16, torch.int32):
        raise ValueError("expected a non-empty int16/int32 (H, W) or (B, H, W) "
                         f"NMS map, got {nm.dtype} {tuple(nm.shape)}")
    h, w = nm.shape
    if nm.device.type == "cpu":
        out, steps = hysteresis_packed_masks(
            pack_mask(nm >= min_val), pack_mask(nm >= max_val), h, w,
            strict=strict)
        if not packed_out:
            out = unpack_edges(out, w)
    elif nm.device.type == "cuda":
        out, steps = _launch(nm.device, h, w, nm=nm.contiguous(), lo=min_val,
                             hi=max_val, int16_out=not packed_out,
                             strict=strict)
        if return_steps:
            steps = steps.clone()
    else:
        raise ValueError(f"unsupported device {nm.device}")
    return (out, steps) if return_steps else out
