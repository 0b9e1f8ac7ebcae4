"""Plain PyTorch front end (K1's plain version): uint8 -> NMS magnitude.

The function of ``canny_edge_tpu/ops/window.py:frontend_nm_static`` (a
whole image, :func:`frontend_nm`) and of its ``window_nm`` (one block of a
larger image, halo included, at its global offsets: :func:`frontend_block`),
written the direct way: zero pad, tap loop, divide, floor, Sobel, integer
square root, NMS and, with ``thresholds``, the compares and the 32-to-1
packing.  Eager PyTorch rounds every ``mul`` and ``add`` on its own (no FMA
contraction across ops) and its float32 ``/`` is IEEE, so the reference's
arithmetic is reproduced bit for bit on the CPU and on the card without the
division-free tricks the TPU needed.

Semantics (reference ``src/utils.cpp``, golden model in the JAX package):

* blur: ``acc = acc + round(x * k[t])`` in ascending tap order; texels
  outside the image are 0 and add +0.0; the divisor is the float32 tap-order
  sum of the in-image weights; only the y-pass quotient is floored;
* Sobel: gx takes clamped columns and drops off-image row terms, gy takes
  clamped rows and drops off-image column terms;
* magnitude ``floor(sqrt(gx^2 + gy^2))`` exactly;
* NMS: ``keep = m0 > max(direction pair)``, ties suppress, off-image
  neighbours read -32768 and so never suppress.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .packed import pack_mask
from .shifts import clamp_shift_cols, clamp_shift_rows

NMS_OOB = -32768


def count_vector(g0: int, n: int, size: int, kernel) -> np.ndarray:
    """float32 blur divisors of the global positions ``g0 .. g0 + n - 1`` of
    an axis of ``size``: the tap-order sum of the in-image weights; 1 off
    the image, where the quotient is never read."""
    kernel = np.asarray(kernel, np.float32)
    c = kernel.shape[0] // 2
    g = g0 + np.arange(n)
    cnt = np.zeros(n, np.float32)
    for t in range(kernel.shape[0]):
        m = ((g + t - c) >= 0) & ((g + t - c) < size)
        cnt = (cnt + np.where(m, kernel[t], np.float32(0))).astype(np.float32)
    return np.where((g >= 0) & (g < size), cnt, np.float32(1))


def renorm_count(n: int, kernel: np.ndarray) -> np.ndarray:
    """float32 divisor per position: the tap-order sum of in-range weights."""
    return count_vector(0, n, n, kernel)


def isqrt(n: torch.Tensor) -> torch.Tensor:
    """Exact floor(sqrt(n)) for int32 ``0 <= n <= ~2.1e6``."""
    k = torch.floor(torch.sqrt(n.to(torch.float64))).to(torch.int32)
    k = torch.where((k + 1) * (k + 1) <= n, k + 1, k)
    return torch.where(k * k > n, k - 1, k)


def blur(img: torch.Tensor, kernel) -> torch.Tensor:
    """uint8 (..., H, W) -> float32 floored renormalized Gaussian blur."""
    kernel = np.asarray(kernel, np.float32)
    h, w = img.shape[-2:]
    c = kernel.shape[0] // 2
    dev = img.device
    x = F.pad(img.to(torch.float32), (c, c))
    acc = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    for t in range(kernel.shape[0]):
        acc = acc + x[..., t:t + w] * float(kernel[t])
    temp = acc / torch.from_numpy(renorm_count(w, kernel)).to(dev)
    temp = F.pad(temp, (0, 0, c, c))
    acc = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    for t in range(kernel.shape[0]):
        acc = acc + temp[..., t:t + h, :] * float(kernel[t])
    return torch.floor(
        acc / torch.from_numpy(renorm_count(h, kernel)).to(dev)[:, None])


def sobel(sm: torch.Tensor):
    """Integer-valued (..., H, W) -> int32 (gx, gy) with the reference borders."""
    s = sm.to(torch.int32)
    d = clamp_shift_cols(s, 1) - clamp_shift_cols(s, -1)
    gx = 2 * d
    gx[..., :-1, :] += d[..., 1:, :]
    gx[..., 1:, :] += d[..., :-1, :]
    e = clamp_shift_rows(s, 1) - clamp_shift_rows(s, -1)
    gy = 2 * e
    gy[..., :-1] += e[..., 1:]
    gy[..., 1:] += e[..., :-1]
    return gx, gy


def nms(gx: torch.Tensor, gy: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """int32 gradients (h, w) and magnitudes with a ring of one (h+2, w+2),
    -32768 off the image -> int32 NMS magnitude (the max-cascade form)."""
    h, w = gx.shape
    mag = mp[1:1 + h, 1:1 + w]

    def nb(dr, dc):
        return mp[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    ax, ay = gx.abs(), gy.abs()
    diff2 = (ax - ay) * (ax - ay)
    low = (ax > ay) & (2 * ay * ay < diff2)
    high = (ay > ax) & (diff2 > 2 * ax * ax)
    sp = gx * gy
    maxh = torch.maximum(nb(0, -1), nb(0, 1))
    thr = torch.where(
        high, torch.maximum(nb(-1, 0), nb(1, 0)),
        torch.where(low, maxh,
                    torch.where(sp > 0, torch.maximum(nb(-1, 1), nb(1, -1)),
                                torch.where(sp < 0,
                                            torch.maximum(nb(-1, -1), nb(1, 1)),
                                            maxh))))
    return torch.where(mag > thr, mag, torch.zeros_like(mag))


def frontend_block(window: torch.Tensor, row0: int, col0: int, H: int, W: int,
                   kernel, thresholds=None):
    """The front end of one block of a larger image (K1 block mode's plain
    version; ``canny_edge_tpu/ops/window.py:window_nm`` with the fused tail
    of ``frontend_nm_static``).

    ``window``: uint8 ``(hl + 2r, wl + 2r)``, ``r = window // 2 + 2``,
    holding global rows ``[row0 - r, row0 + hl + r)`` and columns ``[col0 -
    r, col0 + wl + r)``, zero beyond the ``(H, W)`` image.  Returns the int32
    NMS magnitude of the ``(hl, wl)`` core, or with ``thresholds = (min_val,
    max_val)`` its packed uint32 ``(weak, strong)`` masks ``(hl, ceil(wl /
    32))``.  The blur divisors, the Sobel clamps and drops and NMS's
    off-image neighbours follow the global image border; core pixels past
    the image are 0 in the map and clear in both masks (so that ``min_val
    = 0`` cannot mark padding weak).
    """
    kernel = np.asarray(kernel, np.float32)
    c = kernel.shape[0] // 2
    r = c + 2
    hl, wl = window.shape[0] - 2 * r, window.shape[1] - 2 * r
    if hl < 1 or wl < 1:
        raise ValueError(f"window {tuple(window.shape)} has no core for a "
                         f"halo of {r}")
    dev = window.device
    x = window.to(torch.float32)
    # blur: x pass over every window row, columns col0 - 2 .. col0 + wl + 1;
    # y pass to rows row0 - 2 .. row0 + hl + 1; taps in ascending order
    wo, ho = wl + 4, hl + 4
    acc = torch.zeros((x.shape[0], wo), dtype=torch.float32, device=dev)
    for t in range(kernel.shape[0]):
        acc = acc + x[:, t:t + wo] * float(kernel[t])
    temp = acc / torch.from_numpy(count_vector(col0 - 2, wo, W, kernel)).to(dev)
    acc = torch.zeros((ho, wo), dtype=torch.float32, device=dev)
    for t in range(kernel.shape[0]):
        acc = acc + temp[t:t + ho] * float(kernel[t])
    cnt = torch.from_numpy(count_vector(row0 - 2, ho, H, kernel)).to(dev)
    s = torch.floor(acc / cnt[:, None]).to(torch.int32)

    # Sobel on rows row0 - 1 .. row0 + hl, columns col0 - 1 .. col0 + wl:
    # gx takes clamped columns and drops off-image row terms, gy the reverse
    gr = row0 - 1 + torch.arange(hl + 2, device=dev)[:, None]
    gc = col0 - 1 + torch.arange(wl + 2, device=dev)[None, :]
    mid = s[:, 1:-1]
    d = (torch.where(gc + 1 < W, s[:, 2:], mid)
         - torch.where(gc - 1 >= 0, s[:, :-2], mid))
    gx = (2 * d[1:-1] + torch.where(gr + 1 < H, d[2:], 0)
          + torch.where(gr - 1 >= 0, d[:-2], 0))
    mid = s[1:-1]
    e = (torch.where(gr + 1 < H, s[2:], mid)
         - torch.where(gr - 1 >= 0, s[:-2], mid))
    gy = (2 * e[:, 1:-1] + torch.where(gc + 1 < W, e[:, 2:], 0)
          + torch.where(gc - 1 >= 0, e[:, :-2], 0))
    inside = (gr >= 0) & (gr < H) & (gc >= 0) & (gc < W)
    mp = torch.where(inside, isqrt(gx * gx + gy * gy), NMS_OOB)

    core = inside[1:-1, 1:-1]
    nm = torch.where(core, nms(gx[1:-1, 1:-1], gy[1:-1, 1:-1], mp), 0)
    if thresholds is None:
        return nm
    mn, mx = thresholds
    return (pack_mask((nm >= int(mn)) & core),
            pack_mask((nm >= int(mx)) & core))


def frontend_nm(img: torch.Tensor, kernel, thresholds=None):
    """uint8 (H, W) -> int32 NMS magnitude (H, W), on ``img``'s device.

    ``kernel``: the float32 Gaussian taps (host values).  ``thresholds``:
    optional ``(min_val, max_val)``; then the result is the pair of packed
    uint32 ``(weak, strong)`` masks ``(nm >= min_val, nm >= max_val)``.
    The whole image is the block at (0, 0) of itself.
    """
    r = np.asarray(kernel).shape[0] // 2 + 2
    h, w = img.shape
    return frontend_block(F.pad(img, (r, r, r, r)), 0, 0, h, w, kernel,
                          thresholds)
