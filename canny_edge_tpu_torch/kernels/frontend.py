"""Wrapper of K1, the front-end kernel (``csrc/frontend.cu``).

uint8 ``(H, W)`` -> int16 NMS magnitude ``(H, W)``, or, with thresholds,
the packed uint32 ``(weak, strong)`` masks ``(H, ceil(W/32))``
(:func:`frontend`); the same for one block of a larger image, given its
window with the halo (:func:`frontend_block`, K1's block mode).  A CPU
tensor goes to the plain version (:mod:`..ops.window`); a CUDA tensor goes
to the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.packed import cdiv
from ..ops.window import frontend_block as frontend_block_plain
from ..ops.window import frontend_nm as frontend_plain
from . import _build

# kernel launches made by this wrapper (the main path's proof of use): all,
# and those in block mode
launches = 0
block_launches = 0

_max_window: dict[int, int] = {}


def max_window(device: torch.device) -> int:
    """The largest window the kernel takes on ``device`` (a CUDA device),
    as its shared memory allows (asked of the library once a device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _max_window:
        with _build.device_guard(torch.device("cuda", idx)):
            _max_window[idx] = \
                _build.load("frontend").canny_frontend_max_window()
    return _max_window[idx]


def _check_taps(taps: torch.Tensor) -> int:
    window = taps.shape[0] if taps.dim() == 1 else 0
    if taps.dtype != torch.float32 or window % 2 != 1:
        raise ValueError("taps must be a 1-D float32 tensor of odd length")
    return window


def _launch(entry: str, args, src: torch.Tensor, taps: torch.Tensor,
            oh: int, ow: int, thresholds):
    """Check the device and the window, allocate the outputs, launch."""
    dev = src.device
    if dev.type != "cuda" or taps.device != dev:
        raise ValueError(f"image on {dev} and taps on {taps.device}: "
                         "both must be on the same CUDA device")
    window = taps.shape[0]
    if window > max_window(dev):
        raise ValueError(f"window {window} does not fit the kernel's shared "
                         f"memory on {dev}: the largest is {max_window(dev)}")
    taps = taps.contiguous()
    if thresholds is None:
        nm = torch.empty((oh, ow), dtype=torch.int16, device=dev)
        out = (0, 0, 0, nm.data_ptr(), None, None)
    else:
        weak = torch.empty((oh, cdiv(ow, 32)), dtype=torch.uint32, device=dev)
        strong = torch.empty_like(weak)
        # the kernel compares 4 * magnitude with 4 * threshold in an int;
        # magnitudes lie in [0, 2**13), so a clamped threshold decides alike
        mn, mx = (min(max(int(t), -1), 1 << 13) for t in thresholds)
        out = (1, mn, mx, None, weak.data_ptr(), strong.data_ptr())
    with _build.device_guard(dev):
        err = getattr(_build.load("frontend"), entry)(
            src.data_ptr(), *args, taps.data_ptr(), window, *out,
            _build.stream_handle(dev))
    _build.check(err, f"{entry} launch")
    return nm if thresholds is None else (weak, strong)


def frontend(img: torch.Tensor, taps: torch.Tensor, thresholds=None):
    """Front end on ``img``'s device; ``taps``: float32 Gaussian weights.

    ``thresholds``: optional ``(min_val, max_val)`` integers.
    """
    global launches
    if img.dtype != torch.uint8 or img.dim() != 2 or img.numel() == 0:
        raise ValueError(f"expected a non-empty uint8 (H, W) image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    _check_taps(taps)
    if img.device.type == "cpu":
        res = frontend_plain(img, taps.cpu().numpy(), thresholds)
        return res.to(torch.int16) if thresholds is None else res
    img = img.contiguous()
    h, w = img.shape
    res = _launch("canny_frontend", (h, w), img, taps, h, w, thresholds)
    launches += 1
    return res


def frontend_block(window: torch.Tensor, row0: int, col0: int, H: int,
                   W: int, taps: torch.Tensor, thresholds=None):
    """Front end of one ``(hl, wl)`` block of an ``(H, W)`` image whose
    pixel ``(row0, col0)`` is the block's first, on ``window``'s device.

    ``window``: uint8 ``(hl + 2r, wl + 2r)`` with ``r = len(taps) // 2 +
    2``, zero past the image; the result is the block's int16 NMS map
    ``(hl, wl)``, or with ``thresholds`` its packed ``(weak, strong)``
    masks ``(hl, ceil(wl/32))``; pixels past the image are 0 and clear.
    """
    global launches, block_launches
    r = _check_taps(taps) // 2 + 2
    hl, wl = window.shape[-2] - 2 * r, window.shape[-1] - 2 * r
    if window.dtype != torch.uint8 or window.dim() != 2 or hl < 1 or wl < 1:
        raise ValueError(f"expected a uint8 window with a halo of {r}, got "
                         f"{window.dtype} {tuple(window.shape)}")
    if row0 < 0 or col0 < 0 or H < 1 or W < 1:
        raise ValueError(f"block at ({row0}, {col0}) of a {H}x{W} image")
    if window.device.type == "cpu":
        res = frontend_block_plain(window, row0, col0, H, W,
                                   taps.cpu().numpy(), thresholds)
        return res.to(torch.int16) if thresholds is None else res
    res = _launch("canny_frontend_block", (hl, wl, r, row0, col0, H, W),
                  window.contiguous(), taps, hl, wl, thresholds)
    launches += 1
    block_launches += 1
    return res
