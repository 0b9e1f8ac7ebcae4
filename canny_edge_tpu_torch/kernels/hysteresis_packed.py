"""Wrapper of K2, the packed hysteresis flood (``csrc/hysteresis_packed.cu``).

Packed uint32 weak/strong masks ``(H, ceil(W/32))`` -> the packed edge mask.
A CPU tensor goes to the plain version
(:func:`..ops.packed.hysteresis_packed_masks`); a CUDA tensor goes to the
kernel, for every shape from 1x1 up, or raises.  :func:`hysteresis_packed_nm`
is the NMS-map entry (``hysteresis_impl="packed"``).
"""

from __future__ import annotations

import torch

from ..ops.packed import cdiv, hysteresis_packed_masks, pack_mask, unpack_edges
from . import _build

# kernel launches made by this wrapper (the main path's proof of use)
launches = 0


def hysteresis_packed(weak: torch.Tensor, strong: torch.Tensor, height: int,
                      width: int, *, strict: bool = False,
                      return_steps: bool = False):
    """Flood ``weak`` from ``strong`` to the fixed point.

    ``strict``: the strict-reference exclusion of the promotion
    (1,0) -> (0,1).  ``return_steps``: also return the number of flood
    steps (kernel: grid-wide steps, a 0-d int32 device tensor; CPU: the
    plain version's rounds).
    """
    global launches
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
        edges, rounds = hysteresis_packed_masks(weak, strong, height, width,
                                                strict=strict)
        return (edges, rounds) if return_steps else edges
    if weak.device.type != "cuda":
        raise ValueError(f"unsupported device {weak.device}")
    weak, strong = weak.contiguous(), strong.contiguous()
    out = torch.empty_like(weak)
    ctl = torch.empty(4, dtype=torch.int32, device=weak.device)
    with torch.cuda.device(weak.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load("hysteresis_packed").canny_hysteresis_packed(
            weak.data_ptr(), strong.data_ptr(), out.data_ptr(), height, width,
            int(bool(strict)), ctl.data_ptr(), stream)
    _build.check(err, "canny_hysteresis_packed launch")
    launches += 1
    return (out, ctl[3]) if return_steps else out


def hysteresis_packed_nm(nm: torch.Tensor, min_val: int, max_val: int, *,
                         strict: bool = False) -> torch.Tensor:
    """int NMS magnitude (H, W) or (B, H, W) -> int16 {0, 255} through K2.

    The counterpart of ``canny_edge_tpu/kernels/hysteresis_packed.py:
    hysteresis_packed_pallas``: the thresholds and the packing are plain
    PyTorch glue (XLA there), the flood is the kernel, frame by frame.
    """
    h, w = nm.shape[-2], nm.shape[-1]
    weak, strong = pack_mask(nm >= min_val), pack_mask(nm >= max_val)
    if nm.dim() == 3:
        edges = torch.stack([hysteresis_packed(a, b, h, w, strict=strict)
                             for a, b in zip(weak, strong)])
    else:
        edges = hysteresis_packed(weak, strong, h, w, strict=strict)
    return unpack_edges(edges, w)
