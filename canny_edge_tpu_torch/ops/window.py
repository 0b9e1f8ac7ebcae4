"""Plain PyTorch front end (K1's plain version): uint8 -> NMS magnitude.

The function of ``canny_edge_tpu/ops/window.py:frontend_nm_static``,
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

NMS_OOB = -32768


def renorm_count(n: int, kernel: np.ndarray) -> np.ndarray:
    """float32 divisor per position: the tap-order sum of in-range weights."""
    c = kernel.shape[0] // 2
    idx = np.arange(n)
    cnt = np.zeros(n, np.float32)
    for t in range(kernel.shape[0]):
        m = ((idx + t - c) >= 0) & ((idx + t - c) < n)
        cnt = (cnt + np.where(m, kernel[t], np.float32(0))).astype(np.float32)
    return cnt


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
    d = (torch.cat([s[..., 1:], s[..., -1:]], -1)
         - torch.cat([s[..., :1], s[..., :-1]], -1))
    gx = 2 * d
    gx[..., :-1, :] += d[..., 1:, :]
    gx[..., 1:, :] += d[..., :-1, :]
    e = (torch.cat([s[..., 1:, :], s[..., -1:, :]], -2)
         - torch.cat([s[..., :1, :], s[..., :-1, :]], -2))
    gy = 2 * e
    gy[..., :-1] += e[..., 1:]
    gy[..., 1:] += e[..., :-1]
    return gx, gy


def nms(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """int32 gradients -> int32 NMS magnitude (the max-cascade form)."""
    h, w = gx.shape
    mag = isqrt(gx * gx + gy * gy)
    mp = F.pad(mag, (1, 1, 1, 1), value=NMS_OOB)

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


def frontend_nm(img: torch.Tensor, kernel, thresholds=None):
    """uint8 (H, W) -> int32 NMS magnitude (H, W), on ``img``'s device.

    ``kernel``: the float32 Gaussian taps (host values).  ``thresholds``:
    optional ``(min_val, max_val)``; then the result is the pair of packed
    uint32 ``(weak, strong)`` masks ``(nm >= min_val, nm >= max_val)``.
    """
    nm = nms(*sobel(blur(img, kernel)))
    if thresholds is None:
        return nm
    mn, mx = thresholds
    return pack_mask(nm >= int(mn)), pack_mask(nm >= int(mx))
