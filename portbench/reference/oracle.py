"""Bit-exact NumPy oracle of the reference CPU Canny pipeline: the
benchmark's frozen copy.

A copy of the port's NumPy oracle, kept with the benchmark so that the
yardstick that decides ``correct`` cannot move with the program: it
imports nothing of the program, of JAX or of the JAX package, only NumPy
and SciPy (whose labelling serves :func:`hysteresis`), and it works the
Gaussian taps out again from sigma.  Its functions are the oracle's as
they stood when the benchmark was defined, widened to 16-bit frames: a
uint8 or uint16 frame in, the blur, the gradients, the magnitude and NMS
carried as int32 (a uint16 frame's blur reaches 65535, its gradients
262,140 and its magnitude 370,727, past int16), the squares in int64, and
the int16 {0, 255} map out.  On a uint8 frame every stage gives the values
it gave as int16.  On a uint16 frame this is the port's plain path
(``ops/window.py``: int64 squares, exact integer square root and angle
predicates); the C++ reference's float angle path agrees with it only for
gradients up to 1443 (:func:`quantize_angle`).

Semantics replicated (with reference citations):

* Gaussian kernel: ``window = 1 + 2*ceil(3*sigma)`` computed in float32,
  weights ``exp(-x^2 / (2 sigma^2)) / (sqrt(6.2831853) * sigma)`` with the
  reference's exact mixed float/double expression types, normalized to sum 1
  (``src/utils.cpp:77-95``).
* Separable Gaussian blur with *border renormalization*: out-of-bounds taps
  are skipped and the weighted sum is divided by the sum of in-bounds weights.
  Accumulation is sequential float32 in ascending tap order; the final value
  is truncation-cast to an integer after the y pass only
  (``src/utils.cpp:26-68``).
* Sobel x/y gradient with the reference's hand-unrolled border rules:
  a missing horizontal neighbor is replaced by the centre-column pixel for
  grad_x (clamped column), a missing row term is dropped entirely; transposed
  rules for grad_y (``src/utils.cpp:106-187``).
* Gradient magnitude ``(int)sqrt(gx^2+gy^2)`` (exact integer sqrt — see
  :func:`magnitude_int` for the proof this equals the C++ double-sqrt
  truncation), and gradient direction quantized to {0,45,90,135} with bin
  edges at 22.5 + k*45 degrees (``src/utils.cpp:210-231``).  Binning here is
  done with *exact integer predicates* which provably agree with the C++
  float path for all reachable integer gradients (see :func:`quantize_angle`).
* Non-max suppression with ties suppressed (``<=``) and out-of-bounds
  neighbors never suppressing (``src/utils.cpp:248-308``).
* Hysteresis: ``< minVal -> 0``; BFS from every ``>= maxVal`` seed promoting
  8-connected ``>= minVal`` pixels to EDGE(255); then ``< maxVal -> 0``
  (``src/utils.cpp:322-427``).  The result set equals: the union of
  8-connected components of the weak mask (``>= minVal``) that contain at
  least one strong pixel (``>= maxVal``).
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

EDGE = 255  # src/utils.h:5
NOEDGE = 0  # src/utils.h:6


# ---------------------------------------------------------------------------
# Stage 1: Gaussian kernel + separable blur
# ---------------------------------------------------------------------------

def gaussian_window(sigma: float) -> int:
    """Kernel width: ``1 + 2*ceil(3*sigma)`` with float32 ``3*sigma``.

    Matches ``src/utils.cpp:78`` where ``3*sigma`` is computed in float
    before ``ceil``.
    """
    three_sigma = np.float32(3) * np.float32(sigma)
    return int(1 + 2 * math.ceil(float(three_sigma)))


def gaussian_kernel(sigma: float) -> np.ndarray:
    """float32 Gaussian weights, normalized to sum 1 (src/utils.cpp:77-95).

    The reference computes, per tap i (x = float(i - center)):
        ``product = exp(-(x*x)/(2*sigma*sigma)) / (sqrt(6.2831853)*sigma)``
    where the exp argument and exp itself are float32 (expf), and the final
    division happens in double before truncating back to float32.  The
    normalizer is the sequential float32 sum of the taps.
    """
    window = gaussian_window(sigma)
    center = window // 2
    sig = np.float32(sigma)
    denom = np.float32(np.float32(2) * sig * sig)  # float32, left-assoc

    x = (np.arange(window) - center).astype(np.float32)
    arg = -(x * x / denom)                         # all float32
    # expf: modern glibc's float32 exp is correctly rounded, which equals
    # rounding the float64 exp of the (exact) float32 argument.  NumPy's
    # native float32 np.exp is a SIMD polynomial that differs from expf by
    # 1 ulp on ~40% of this domain and would silently redefine the kernel.
    e = np.exp(arg.astype(np.float64)).astype(np.float32)
    # double-precision divisor: sqrt(6.2831853) [double] * sigma [float]
    d = math.sqrt(6.2831853) * float(sig)
    product = (e.astype(np.float64) / d).astype(np.float32)

    s = np.float32(0.0)
    for i in range(window):                        # sequential float32 sum
        s = np.float32(s + product[i])
    return (product / s).astype(np.float32)


def _shift_cols(x: np.ndarray, off: int, fill=0) -> np.ndarray:
    """Return y with y[:, j] = x[:, j+off] where valid, ``fill`` elsewhere."""
    h, w = x.shape
    y = np.full_like(x, fill)
    if off >= 0:
        if off < w:
            y[:, : w - off] = x[:, off:]
    else:
        if -off < w:
            y[:, -off:] = x[:, :w + off]
    return y


def _shift_rows(x: np.ndarray, off: int, fill=0) -> np.ndarray:
    return _shift_cols(x.T, off, fill).T


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable renormalized blur, uint8 or uint16 -> int32
    (src/utils.cpp:26-68; every level of a uint16 frame is exact in
    float32).

    Accumulation is vectorized but preserves the reference's sequential
    float32 tap order exactly: adding a (+0.0) masked contribution is an
    IEEE no-op, so the per-pixel float32 result is bit-identical to the
    scalar loop.
    """
    assert img.dtype in (np.uint8, np.uint16), img.dtype
    kernel = gaussian_kernel(sigma)
    window = kernel.shape[0]
    center = window // 2
    h, w = img.shape
    x = img.astype(np.float32)

    col = np.arange(w)[None, :]
    acc = np.zeros((h, w), np.float32)
    cnt = np.zeros((h, w), np.float32)
    for t in range(window):
        off = t - center
        m = (col + off >= 0) & (col + off < w)
        sh = _shift_cols(x, off)
        acc = acc + np.where(m, sh * kernel[t], np.float32(0.0))
        cnt = cnt + np.where(m, np.full((h, w), kernel[t], np.float32),
                             np.float32(0.0))
    temp = acc / cnt                                # float32 divide

    row = np.arange(h)[:, None]
    acc = np.zeros((h, w), np.float32)
    cnt = np.zeros((h, w), np.float32)
    for t in range(window):
        off = t - center
        m = (row + off >= 0) & (row + off < h)
        sh = _shift_rows(temp, off)
        acc = acc + np.where(m, sh * kernel[t], np.float32(0.0))
        cnt = cnt + np.where(m, np.full((h, w), kernel[t], np.float32),
                             np.float32(0.0))
    out = acc / cnt
    return out.astype(np.int32)                     # truncation cast


# ---------------------------------------------------------------------------
# Stage 2: Sobel gradient, magnitude, quantized angle
# ---------------------------------------------------------------------------

def xy_gradient(img: np.ndarray):
    """Sobel x/y gradients with the reference border rules.

    grad_x (src/utils.cpp:114-149): for each row term dr in {-1(w=1), 0(w=2),
    +1(w=1)}, the contribution is ``X[r+dr, c+1] - X[r+dr, c-1]`` with the
    *column clamped* to the image (so at c=0 the missing left neighbor is the
    centre column itself), and the whole row term *dropped* when r+dr is
    outside the image.

    grad_y (src/utils.cpp:155-186): transposed rule — rows clamped, missing
    column terms dropped.  Note the code computes (row below) - (row above),
    i.e. +y points down the image.
    """
    x = img.astype(np.int32)
    h, w = x.shape

    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)   # clamp c+1
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)    # clamp c-1
    d = right - left
    gx = 2 * d
    gx[:-1, :] += d[1:, :]       # row below exists for r < h-1
    gx[1:, :] += d[:-1, :]       # row above exists for r > 0

    below = np.concatenate([x[1:, :], x[-1:, :]], axis=0)   # clamp r+1
    above = np.concatenate([x[:1, :], x[:-1, :]], axis=0)   # clamp r-1
    e = below - above
    gy = 2 * e
    gy[:, :-1] += e[:, 1:]       # column right exists for c < w-1
    gy[:, 1:] += e[:, :-1]       # column left exists for c > 0

    return gx, gy


def magnitude_int(gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """``(int)sqrt(gx*gx + gy*gy)`` == exact integer isqrt.

    The C++ (src/utils.cpp:212) computes sqrt in double then truncates.  For
    n = gx^2+gy^2 <= ~2.1e6: if n is a perfect square k^2, double sqrt is
    exactly k; otherwise the true sqrt is irrational with distance from the
    nearest integer >= 1/(2*1443+1) ~ 3.5e-4, far above the 0.5-ulp double
    rounding error, so truncation of the rounded double sqrt equals
    floor(sqrt(n)) exactly.  Hence integer isqrt is bit-identical.  Past
    that (a uint16 frame's n reaches 1.37e11) the integer fix-ups make the
    result floor(sqrt(n)) whatever the double rounds to.
    """
    n = gx.astype(np.int64) ** 2 + gy.astype(np.int64) ** 2
    s = np.floor(np.sqrt(n.astype(np.float64))).astype(np.int64)
    # belt-and-braces integer fix (no-ops for correctly rounded f64 sqrt)
    s = np.where((s + 1) * (s + 1) <= n, s + 1, s)
    s = np.where(s * s > n, s - 1, s)
    return s.astype(np.int32)


def quantize_angle(gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """Quantize atan2(gy,gx) to {0,45,90,135} with exact integer predicates.

    The C++ (src/utils.cpp:215-231) computes ``atan2`` in double, truncates
    to float32, converts to degrees, wraps negatives by +360, and bins with
    edges at 22.5 + k*45.  Because the bin edges correspond to irrational
    slopes (tan 22.5 = sqrt(2)-1), no integer (gx, gy) pair lies exactly on
    an edge; the closest approach for |g| <= 1443 is ~2.1e-5 degrees
    (continued-fraction convergent 408/985 of sqrt(2)-1), while the float32
    rounding error of the C++ path is <= ~3e-6 degrees.  Therefore the C++
    binning equals ideal real-arithmetic binning, which this function
    computes exactly:

      * slope < tan 22.5  <=>  ax > ay and 2*ay^2 < (ax-ay)^2
      * slope > tan 67.5  <=>  ay > ax and (ay-ax)^2 > 2*ax^2
      * same-sign (gx*gy > 0):      low->0, mid->45, high->90
      * opposite-sign (gx*gy < 0):  low->0, mid->135, high->90
      * gy == 0 -> 0 ; gx == 0 (gy != 0) -> 90
    """
    gxi = gx.astype(np.int64)
    gyi = gy.astype(np.int64)
    ax = np.abs(gxi)
    ay = np.abs(gyi)
    low = (ax > ay) & (2 * ay * ay < (ax - ay) ** 2)
    high = (ay > ax) & ((ay - ax) ** 2 > 2 * ax * ax)
    mid = ~low & ~high
    same = (gxi * gyi) > 0
    opp = (gxi * gyi) < 0

    out = np.zeros(gx.shape, np.int16)
    out[(gxi == 0) & (gyi != 0)] = 90
    out[same & mid] = 45
    out[opp & mid] = 135
    out[(same | opp) & high] = 90
    # low -> 0, gy==0 -> 0: already zero
    return out


def quantize_angle_cpp_float(gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """Direct simulation of the C++ float path, for cross-validation only.

    float temp_angle = atan2((double)gy, (double)gx);   // double -> float32
    temp_angle *= (180/PI);   // PI = 3.1415926535 (double); result -> float32
    if (temp_angle < 0) temp_angle = 360 + temp_angle;
    then the bin chain of src/utils.cpp:220-231.
    """
    a = np.arctan2(gy.astype(np.float64), gx.astype(np.float64))
    a = a.astype(np.float32)
    a = (a.astype(np.float64) * (180.0 / 3.1415926535)).astype(np.float32)
    a = np.where(a < 0, (np.float64(360.0) + a).astype(np.float32), a)

    out = np.zeros(gx.shape, np.int16)
    b45 = ((a >= 22.5) & (a < 67.5)) | ((a >= 202.5) & (a < 247.5))
    b135 = ((a >= 112.5) & (a < 157.5)) | ((a >= 292.5) & (a < 337.5))
    b90 = ((a >= 67.5) & (a < 112.5)) | ((a >= 247.5) & (a < 292.5))
    out[b45] = 45
    out[~b45 & b135] = 135
    out[~b45 & ~b135 & b90] = 90
    return out


def sobel(img: np.ndarray):
    """Full Sobel stage: (magnitude, angle) from a blurred int32 image."""
    gx, gy = xy_gradient(img)
    return magnitude_int(gx, gy), quantize_angle(gx, gy)


# ---------------------------------------------------------------------------
# Stage 3: Non-max suppression
# ---------------------------------------------------------------------------

def nonmax_suppression(mag: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Suppress non-maximal pixels along the quantized gradient direction.

    Matches src/utils.cpp:248-308: a pixel is suppressed when its magnitude
    is ``<=`` either in-bounds neighbor along the gradient direction (ties
    suppressed); out-of-bounds neighbors never suppress.  Neighbor pairs per
    bin: 0 -> left/right; 45 -> upRight/downLeft; 90 -> up/down;
    135 -> upLeft/downRight (rows grow downward).
    """
    m = mag.astype(np.int32)
    oob = np.int32(-32768)  # never >= any magnitude (magnitudes are >= 0)

    def nb(dr, dc):
        return _shift_rows(_shift_cols(m, dc, oob), dr, oob)

    pairs = {
        0: (nb(0, -1), nb(0, 1)),
        45: (nb(-1, 1), nb(1, -1)),
        90: (nb(-1, 0), nb(1, 0)),
        135: (nb(-1, -1), nb(1, 1)),
    }
    out = np.zeros(mag.shape, np.int32)
    for bin_val, (n1, n2) in pairs.items():
        keep = (m > n1) & (m > n2)
        sel = angle == bin_val
        out[sel] = np.where(keep, m, np.int32(NOEDGE))[sel]
    return out


# ---------------------------------------------------------------------------
# Stage 4: Hysteresis (BFS + component formulations)
# ---------------------------------------------------------------------------

def _neighbours(cur: int, w: int, total: int) -> list[int]:
    """The 8-connected neighbours of flat index ``cur`` that the reference's
    BFS looks at, with its bounds checks (src/utils.cpp:360-427), including
    ``current - width > 0`` for the upper diagonals, which skips the
    top-left corner's upper row."""
    cands = []
    if cur % w > 0:
        if cur + w < total:
            cands.append(cur + w - 1)
        if cur - w > 0:
            cands.append(cur - w - 1)
        cands.append(cur - 1)
    if cur % w < w - 1:
        if cur + w < total:
            cands.append(cur + w + 1)
        if cur - w > 0:
            cands.append(cur - w + 1)
        cands.append(cur + 1)
    if cur + w < total:
        cands.append(cur + w)
    if cur - w >= 0:
        cands.append(cur - w)
    return cands


def find_edge_pixels(arr: np.ndarray, visited: np.ndarray, start: int,
                     min_val: int, max_val: int, h: int, w: int) -> None:
    """In-place BFS promotion from ``start`` (src/utils.cpp:360-427).

    Pops pixels off a FIFO queue, sets them to EDGE, and enqueues every
    8-connected neighbor whose value is >= min_val and not yet visited.
    The seed itself is promoted unconditionally.  Mirrors the reference's
    neighbor bounds checks exactly (:func:`_neighbours`).
    """
    flat = arr.reshape(-1)
    vis = visited.reshape(-1)
    if vis[start]:
        return
    q = deque([start])
    total = h * w
    while q:
        cur = q[0]
        flat[cur] = EDGE
        for nxt in _neighbours(cur, w, total):
            if flat[nxt] >= min_val and not vis[nxt]:
                q.append(nxt)
                vis[nxt] = True
        q.popleft()


def hysteresis_bfs(nm: np.ndarray, min_val: int, max_val: int) -> np.ndarray:
    """Literal two-pass BFS hysteresis (src/utils.cpp:322-342); int16
    {0, 255} out.  It writes EDGE (255) into the magnitudes it reads, so
    it is the strict mode's rule only while both thresholds are at most
    255 (:func:`hysteresis_strict`)."""
    out = nm.copy()
    h, w = out.shape
    visited = np.zeros((h, w), bool)
    flat = out.reshape(-1)
    for i in range(h * w):
        if flat[i] < min_val:
            flat[i] = NOEDGE
        elif flat[i] >= max_val:
            find_edge_pixels(out, visited, i, min_val, max_val, h, w)
    flat[flat < max_val] = NOEDGE
    return out.astype(np.int16)


def hysteresis_strict(nm: np.ndarray, min_val: int,
                      max_val: int) -> np.ndarray:
    """Oracle for the "strict-reference" hysteresis mode: the reference's
    BFS with its ``current - width > 0`` bounds quirk preserved, from every
    pixel that is both weak and strong (the reference zeroes a pixel under
    ``min_val`` before it looks for a seed), through weak pixels, with its
    marks kept in a mask of their own; int16 {0, 255} out.

    Equal to :func:`hysteresis_bfs` wherever both thresholds are at most
    255, which covers every 8-bit configuration of the benchmark.  Above
    that the literal BFS reads its own EDGE marks as magnitudes (a mark of
    255 is under ``max_val`` and is cleared), so a 16-bit frame's
    thresholds, or an 8-bit frame's past 255, need the marks apart: the
    rule then depends on the masks ``nm >= min_val`` and ``nm >= max_val``
    alone, as the port's strict path does.
    """
    h, w = nm.shape
    total = h * w
    flat = nm.reshape(-1)
    weak = flat >= min_val
    edge = np.zeros(total, bool)
    for start in np.flatnonzero(weak & (flat >= max_val)):
        if edge[start]:
            continue
        edge[start] = True
        q = deque([int(start)])
        while q:
            cur = q.popleft()
            for nxt in _neighbours(cur, w, total):
                if weak[nxt] and not edge[nxt]:
                    edge[nxt] = True
                    q.append(nxt)
    return np.where(edge, np.int16(EDGE), np.int16(NOEDGE)).reshape(h, w)


def hysteresis(nm: np.ndarray, min_val: int, max_val: int) -> np.ndarray:
    """Component-rule hysteresis: EDGE(255) on every 8-connected component
    of {nm >= min_val} containing a pixel >= max_val, NOEDGE(0) elsewhere.

    Equal to :func:`hysteresis_bfs` everywhere except one reference bug the
    framework deliberately fixes: the BFS's upper-diagonal bounds checks use
    ``current - width > 0`` instead of ``>= 0`` (src/utils.cpp:378,399), so
    from the pixel at (row 1, col 0) it never enqueues its top-right
    neighbor (0, 1).  A weak pixel at (0, 1) whose only connection to a
    strong region runs through that directed edge is EDGE under the clean
    component rule but NOEDGE in the reference binary.  See
    tests/test_golden.py::test_reference_bfs_row1_col0_quirk for the
    counterexample, and docs/DESIGN.md §5.
    """
    from scipy import ndimage

    weak = nm >= min_val
    strong = nm >= max_val
    labels, n = ndimage.label(weak, structure=np.ones((3, 3), np.int32))
    if n == 0:
        return np.zeros(nm.shape, np.int16)
    strong_labels = np.unique(labels[strong])
    strong_labels = strong_labels[strong_labels > 0]
    keep = np.isin(labels, strong_labels) & weak
    return np.where(keep, np.int16(EDGE), np.int16(NOEDGE))


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def canny(img: np.ndarray, sigma: float, min_val: int, max_val: int,
          intermediates: bool = False):
    """Full golden Canny pipeline: uint8 or uint16 (H, W) -> int16
    {0, 255} (H, W).

    Mirrors ``canny()`` in src/utils.cpp:429-492 (minus the display calls).
    """
    smoothed = gaussian_blur(img, sigma)
    mag, ang = sobel(smoothed)
    nm = nonmax_suppression(mag, ang)
    out = hysteresis(nm, min_val, max_val)
    if intermediates:
        return out, {"smoothed": smoothed, "magnitude": mag, "angle": ang,
                     "nonmax": nm}
    return out
