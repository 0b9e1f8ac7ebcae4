"""Wrapper of K1, the front-end kernel (``csrc/frontend.cu``).

uint8 ``(H, W)`` -> int16 NMS magnitude ``(H, W)``, or, with thresholds,
the packed uint32 ``(weak, strong)`` masks ``(H, ceil(W/32))``.  A CPU
tensor goes to the plain version (:func:`..ops.window.frontend_nm`); a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.packed import cdiv
from ..ops.window import frontend_nm as frontend_plain
from . import _build

# kernel launches made by this wrapper (the main path's proof of use)
launches = 0


def max_window() -> int:
    return _build.load("frontend").canny_frontend_max_window()


def frontend(img: torch.Tensor, taps: torch.Tensor, thresholds=None):
    """Front end on ``img``'s device; ``taps``: float32 Gaussian weights.

    ``thresholds``: optional ``(min_val, max_val)`` integers.
    """
    global launches
    if img.dtype != torch.uint8 or img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"expected a non-empty uint8 (H, W) image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if taps.dtype != torch.float32 or taps.dim() != 1 or len(taps) % 2 != 1:
        raise ValueError("taps must be a 1-D float32 tensor of odd length")
    if img.device.type == "cpu":
        out = frontend_plain(img, taps.cpu().numpy(), thresholds)
        return out.to(torch.int16) if thresholds is None else out
    if img.device.type != "cuda" or taps.device != img.device:
        raise ValueError(f"image on {img.device} and taps on {taps.device}: "
                         "both must be on the same CUDA device")
    if len(taps) > max_window():
        raise ValueError(f"window {len(taps)} exceeds the kernel's "
                         f"maximum of {max_window()}")
    img, taps = img.contiguous(), taps.contiguous()
    h, w = img.shape
    packed = thresholds is not None
    mn, mx = (int(thresholds[0]), int(thresholds[1])) if packed else (0, 0)
    if packed:
        weak = torch.empty((h, cdiv(w, 32)), dtype=torch.uint32,
                           device=img.device)
        strong = torch.empty_like(weak)
        nm = None
    else:
        nm = torch.empty((h, w), dtype=torch.int16, device=img.device)
        weak = strong = None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.load("frontend").canny_frontend(
            img.data_ptr(), h, w, taps.data_ptr(), len(taps), int(packed),
            mn, mx, ptr(nm), ptr(weak), ptr(strong), stream)
    _build.check(err, "canny_frontend launch")
    launches += 1
    return (weak, strong) if packed else nm
