"""The whole Canny pipeline in plain PyTorch, for uint8 and uint16 frames:
a second reference, independent of the program, that runs on the card.

It imports nothing of the program, of JAX or of the JAX package: only
PyTorch and the standard library.  It follows the frozen NumPy oracle
(``reference/oracle.py``), which still decides ``correct``; this file is
for checking whole tiles on the card, where the oracle takes a minute of
the host a 10980x10980 tile.  :func:`canny` takes an ``(H, W)`` uint8 or
uint16 tensor, on the CPU or a card, and gives the oracle's int16
``{0, 255}`` map on the same device:

* the float32 taps worked out from sigma as the oracle does (the argument
  of the exponential in float32, the exponential in float64 rounded to
  float32, the divisor ``sqrt(6.2831853) * sigma`` in float64, the sum in
  float32 in tap order);
* a renormalised separable blur summed tap by tap in the oracle's order,
  one float32 product and one float32 sum each (separate operations, so
  nothing fuses them into an FMA), divided by the float32 tap-order sum of
  the in-image weights, and truncated to an integer after the y pass;
* the reference's Sobel border rules (clamped columns and dropped row
  terms for gx, the transpose for gy), in int64;
* ``gx^2 + gy^2`` in int64, its exact integer square root, the oracle's
  exact angle predicates, and NMS with ties suppressed and off-image
  neighbours never suppressing;
* the component hysteresis: strong pixels (``>= max_val``) that are weak
  (``>= min_val``), grown by 8-neighbour reach inside the weak mask until
  nothing changes.

Where it departs from the oracle's text (none changes a value):

* off-image texels are zeros from padding rather than masked shifts:
  the oracle adds ``where(mask, 0 * k, 0.0)``, this adds ``0 * k``, both
  +0.0, which leaves a float32 sum as it was;
* the renormalisation divisors are one vector an axis, each summed in
  tap order over the taps that land in the image, rather than a full
  array accumulated with masks (the same sums);
* the hysteresis grows reach by 3x3 max-pooling until a fixed point,
  checking every few rounds, rather than labelling components with SciPy
  (the same set: a weak pixel is kept iff a path of weak pixels joins it
  to a strong one);
* the NMS sentinel for off-image neighbours is -1 rather than -32768
  (magnitudes are at least 0, so neither ever suppresses).
"""

from __future__ import annotations

import contextlib
import math

import torch

EDGE = 255
# hysteresis rounds between two checks for a fixed point
CHECK_EVERY = 16


def gaussian_window(sigma: float) -> int:
    """``1 + 2 * ceil(3 * sigma)``, with ``3 * sigma`` in float32."""
    three = torch.tensor(3.0, dtype=torch.float32) * torch.tensor(
        sigma, dtype=torch.float32)
    return int(1 + 2 * math.ceil(float(three)))


def gaussian_taps(sigma: float) -> torch.Tensor:
    """The oracle's float32 taps, normalised to sum 1, on the CPU."""
    window = gaussian_window(sigma)
    center = window // 2
    f32 = torch.float32
    sig = torch.tensor(sigma, dtype=f32)
    denom = (torch.tensor(2.0, dtype=f32) * sig) * sig
    x = (torch.arange(window, dtype=torch.int64) - center).to(f32)
    arg = -((x * x) / denom)
    # the float64 exponential of each float32 argument, rounded to float32
    e = torch.tensor([math.exp(a) for a in arg.tolist()],
                     dtype=torch.float64).to(f32)
    d = math.sqrt(6.2831853) * float(sig)
    product = (e.to(torch.float64) / d).to(f32)
    s = torch.tensor(0.0, dtype=f32)
    for i in range(window):
        s = s + product[i]
    return product / s


def _divisors(n: int, taps: torch.Tensor) -> torch.Tensor:
    """float32 (n,): for position j the tap-order sum of the taps that land
    in [0, n)."""
    window = taps.shape[0]
    c = window // 2
    pos = torch.arange(n)
    cnt = torch.zeros(n, dtype=torch.float32)
    for t in range(window):
        q = pos + t - c
        cnt = cnt + torch.where((q >= 0) & (q < n), taps[t],
                                torch.tensor(0.0, dtype=torch.float32))
    return cnt


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """uint8 or uint16 (H, W) -> int64: the renormalised blur, truncated."""
    dev = img.device
    taps = gaussian_taps(sigma)
    window = taps.shape[0]
    c = window // 2
    h, w = img.shape
    k = taps.to(dev)
    x = torch.nn.functional.pad(img.to(torch.float32), (c, c))
    acc = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for t in range(window):
        acc = torch.add(acc, torch.mul(x[:, t:t + w], k[t]))
    temp = torch.div(acc, _divisors(w, taps).to(dev)[None, :])
    del x, acc
    y = torch.nn.functional.pad(temp, (0, 0, c, c))
    del temp
    acc = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for t in range(window):
        acc = torch.add(acc, torch.mul(y[t:t + h], k[t]))
    del y
    out = torch.div(acc, _divisors(h, taps).to(dev)[:, None])
    return out.to(torch.int64)            # truncation (values are >= 0)


def gradients(s: torch.Tensor):
    """Sobel gx, gy (int64) with the reference's border rules."""
    right = torch.cat([s[:, 1:], s[:, -1:]], dim=1)     # clamp c + 1
    left = torch.cat([s[:, :1], s[:, :-1]], dim=1)      # clamp c - 1
    d = right - left
    gx = 2 * d
    gx[:-1] += d[1:]          # the row below exists for r < h - 1
    gx[1:] += d[:-1]          # the row above exists for r > 0
    del right, left, d
    below = torch.cat([s[1:], s[-1:]], dim=0)           # clamp r + 1
    above = torch.cat([s[:1], s[:-1]], dim=0)           # clamp r - 1
    e = below - above
    gy = 2 * e
    gy[:, :-1] += e[:, 1:]    # the column right exists for c < w - 1
    gy[:, 1:] += e[:, :-1]    # the column left exists for c > 0
    return gx, gy


def magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(gx^2 + gy^2)), exact, int64."""
    n = gx * gx + gy * gy
    k = torch.floor(torch.sqrt(n.to(torch.float64))).to(torch.int64)
    k = torch.where((k + 1) * (k + 1) <= n, k + 1, k)
    return torch.where(k * k > n, k - 1, k)


def nonmax(gx: torch.Tensor, gy: torch.Tensor,
           mag: torch.Tensor) -> torch.Tensor:
    """The quantised direction by the oracle's exact predicates, then NMS:
    the kept magnitude, or 0."""
    ax, ay = gx.abs(), gy.abs()
    diff2 = (ax - ay) * (ax - ay)
    low = (ax > ay) & (2 * ay * ay < diff2)
    high = (ay > ax) & (diff2 > 2 * ax * ax)
    del diff2
    sp = torch.sign(gx) * torch.sign(gy)
    h, w = mag.shape
    m = torch.nn.functional.pad(mag, (1, 1, 1, 1), value=-1)

    def nb(dr, dc):
        return m[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    # bins 0 (left/right), 90 (up/down), 45 (up-right/down-left), 135
    # (up-left/down-right); gy == 0 is bin 0, gx == 0 (gy != 0) bin 90
    horiz = low | (gy == 0)
    vert = ~horiz & (high | (gx == 0))
    diag45 = ~horiz & ~vert & (sp > 0)
    n1 = torch.where(horiz, nb(0, -1), torch.where(
        vert, nb(-1, 0), torch.where(diag45, nb(-1, 1), nb(-1, -1))))
    n2 = torch.where(horiz, nb(0, 1), torch.where(
        vert, nb(1, 0), torch.where(diag45, nb(1, -1), nb(1, 1))))
    keep = (mag > n1) & (mag > n2)
    return torch.where(keep, mag, torch.zeros_like(mag))


def hysteresis(nm: torch.Tensor, min_val: int, max_val: int) -> torch.Tensor:
    """int16 {0, 255}: weak pixels joined to a strong one by a path of weak
    pixels (8-connected)."""
    weak = nm >= min_val
    dt = torch.float16 if nm.is_cuda else torch.float32
    reach = (weak & (nm >= max_val)).to(dt)[None, None]
    inside = weak.to(dt)[None, None]
    del weak
    while True:
        before = reach
        for _ in range(CHECK_EVERY):
            reach = torch.nn.functional.max_pool2d(reach, 3, 1, 1) * inside
        if torch.equal(reach, before):
            break
    return torch.where(reach[0, 0] > 0, torch.tensor(EDGE, dtype=torch.int16,
                                                     device=nm.device),
                       torch.tensor(0, dtype=torch.int16, device=nm.device))


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN while the block runs, and the
    process's settings as they were after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def canny(img: torch.Tensor, sigma: float, min_val: int,
          max_val: int) -> torch.Tensor:
    """uint8 or uint16 (H, W) -> int16 {0, 255} (H, W), where ``img`` lies:
    the oracle's map (``reference/oracle.py:canny``), with TF32 off
    (:func:`no_tf32`)."""
    if img.dtype not in (torch.uint8, torch.uint16) or img.dim() != 2:
        raise ValueError(f"expected a uint8 or uint16 (H, W) frame, got "
                         f"{img.dtype} {tuple(img.shape)}")
    with no_tf32():
        s = blur(img, sigma)
        gx, gy = gradients(s)
        del s
        nm = nonmax(gx, gy, magnitude(gx, gy))
        del gx, gy
        return hysteresis(nm, min_val, max_val)
