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


_max_window = None


def max_window() -> int:
    """The largest window the kernel takes (asked of the library once)."""
    global _max_window
    if _max_window is None:
        _max_window = _build.load("frontend").canny_frontend_max_window()
    return _max_window


def frontend(img: torch.Tensor, taps: torch.Tensor, thresholds=None):
    """Front end on ``img``'s device; ``taps``: float32 Gaussian weights.

    ``thresholds``: optional ``(min_val, max_val)`` integers.
    """
    global launches
    if img.dtype != torch.uint8 or img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"expected a non-empty uint8 (H, W) image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    window = taps.shape[0] if taps.dim() == 1 else 0
    if taps.dtype != torch.float32 or window % 2 != 1:
        raise ValueError("taps must be a 1-D float32 tensor of odd length")
    dev = img.device
    if dev.type == "cpu":
        res = frontend_plain(img, taps.cpu().numpy(), thresholds)
        return res.to(torch.int16) if thresholds is None else res
    if dev.type != "cuda" or taps.device != dev:
        raise ValueError(f"image on {dev} and taps on {taps.device}: "
                         "both must be on the same CUDA device")
    if window > max_window():
        raise ValueError(f"window {window} exceeds the kernel's "
                         f"maximum of {max_window()}")
    img, taps = img.contiguous(), taps.contiguous()
    h, w = img.shape
    if thresholds is None:
        nm = torch.empty((h, w), dtype=torch.int16, device=dev)
        args = (0, 0, 0, nm.data_ptr(), None, None)
    else:
        weak = torch.empty((h, cdiv(w, 32)), dtype=torch.uint32, device=dev)
        strong = torch.empty_like(weak)
        # the kernel compares 4 * magnitude with 4 * threshold in an int;
        # magnitudes lie in [0, 2**13), so a clamped threshold decides alike
        mn, mx = (min(max(int(t), -1), 1 << 13) for t in thresholds)
        args = (1, mn, mx, None, weak.data_ptr(), strong.data_ptr())
    with _build.device_guard(dev):
        err = _build.load("frontend").canny_frontend(
            img.data_ptr(), h, w, taps.data_ptr(), window, *args,
            _build.stream_handle(dev))
    _build.check(err, "canny_frontend launch")
    launches += 1
    return nm if thresholds is None else (weak, strong)
