"""Wrapper of K1, the front-end kernel (``csrc/frontend.cu``).

uint8 ``(H, W)`` -> int16 NMS magnitude ``(H, W)``, or, with thresholds,
the packed uint32 ``(weak, strong)`` masks ``(H, ceil(W/32))``
(:func:`frontend`), and the same for a ``(B, H, W)`` batch in one launch
(JAX's ``vmap`` over its kernel); the same for one block of a larger image,
given its window with the halo (:func:`frontend_block`, K1's block mode).
A CPU tensor goes to the plain version (:mod:`..ops.window`, a frame at a
time); a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.packed import cdiv
from ..ops.thresholds import threshold_bound
from ..ops.window import frontend_block as frontend_block_plain
from ..ops.window import frontend_nm as frontend_plain
from . import _build

# kernel launches made by this wrapper (the main path's proof of use): all,
# those in block mode, and those on a batch of two frames or more
launches = 0
block_launches = 0
batch_launches = 0

MAX_BATCH = 65535    # frames a launch: the grid's z limit

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


def _bounds(thresholds):
    """The thresholds as the integers that the kernel and the plain
    version both compare with (:func:`..ops.thresholds.threshold_bound`)."""
    if thresholds is None:
        return None
    return tuple(threshold_bound(t) for t in thresholds)


def _launch(entry: str, args, src: torch.Tensor, taps: torch.Tensor,
            oh: int, ow: int, thresholds, lead=()):
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
        nm = torch.empty((*lead, oh, ow), dtype=torch.int16, device=dev)
        out = (0, 0, 0, nm.data_ptr(), None, None)
    else:
        weak = torch.empty((*lead, oh, cdiv(ow, 32)), dtype=torch.uint32,
                           device=dev)
        strong = torch.empty_like(weak)
        # the kernel compares 4 * magnitude with 4 * threshold in an int;
        # magnitudes lie in [0, 2**13), so a clamped bound decides alike
        mn, mx = (min(max(t, -1), 1 << 13) for t in thresholds)
        out = (1, mn, mx, None, weak.data_ptr(), strong.data_ptr())
    with _build.device_guard(dev):
        err = getattr(_build.load("frontend"), entry)(
            src.data_ptr(), *args, taps.data_ptr(), window, *out,
            _build.stream_handle(dev))
    _build.check(err, f"{entry} launch")
    return nm if thresholds is None else (weak, strong)


def frontend(img: torch.Tensor, taps: torch.Tensor, thresholds=None):
    """Front end on ``img``'s device; ``taps``: float32 Gaussian weights.

    ``img``: uint8 ``(H, W)`` or a batch ``(B, H, W)`` whose results stack
    the frames' (one launch on the card for up to ``MAX_BATCH`` frames, a
    launch a chunk of that many above it).
    ``thresholds``: optional ``(min_val, max_val)``, compared as JAX
    compares an integer map with them (:func:`_bounds`).
    """
    global launches, batch_launches
    thresholds = _bounds(thresholds)
    if img.dtype != torch.uint8 or img.dim() not in (2, 3) \
            or img.numel() == 0:
        raise ValueError(f"expected a non-empty uint8 (H, W) image or "
                         f"(B, H, W) batch, got {img.dtype} "
                         f"{tuple(img.shape)}")
    _check_taps(taps)
    if img.device.type == "cpu":
        if img.dim() == 3:
            res = [frontend(f, taps, thresholds) for f in img]
            return (torch.stack(res) if thresholds is None else
                    tuple(torch.stack(m) for m in zip(*res)))
        res = frontend_plain(img, taps.cpu().numpy(), thresholds)
        return res.to(torch.int16) if thresholds is None else res
    img = img.contiguous()
    h, w = img.shape[-2:]
    # a launch a chunk of at most MAX_BATCH frames (the grid's z limit)
    parts = []
    for chunk in (img.split(MAX_BATCH) if img.dim() == 3 else (img,)):
        b = chunk.shape[0] if chunk.dim() == 3 else 1
        parts.append(_launch("canny_frontend", (b, h, w), chunk, taps, h, w,
                             thresholds, chunk.shape[:-2]))
        launches += 1
        batch_launches += b > 1
    if len(parts) == 1:
        return parts[0]
    return (torch.cat(parts) if thresholds is None else
            tuple(torch.cat(m) for m in zip(*parts)))


def frontend_nm(img: torch.Tensor, kernel_vals, *, tile=None, interpret=None,
                indexing: str = "element", border: str = "strips"):
    """JAX's K1 wrapper under its name and keywords
    (``canny_edge_tpu/kernels/frontend.py:frontend_nm``): uint8 ``(H, W)``
    (or a batch) -> int16 NMS magnitude, :func:`frontend` with the taps
    ``kernel_vals`` (a sequence, an array or a tensor) on ``img``'s device.

    ``tile``, ``interpret`` and ``indexing`` are accepted and unused: they
    chose the TPU kernel's tiles, its interpreter and its ``BlockSpec``
    indexing, none of which changes the result.  ``border`` takes only
    ``"strips"``, the exact border: JAX's ``"none"`` leaves the border
    frame wrong, for profiling, and the port has no such variant.
    """
    del tile, interpret, indexing
    if border != "strips":
        raise ValueError(f"border={border!r}: only the exact border "
                         f"('strips') exists here")
    if not isinstance(kernel_vals, torch.Tensor):
        kernel_vals = torch.from_numpy(
            np.asarray(kernel_vals, np.float32).copy())
    return frontend(img, kernel_vals.to(device=img.device,
                                        dtype=torch.float32))


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
    thresholds = _bounds(thresholds)
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
