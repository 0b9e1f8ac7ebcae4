"""The four Canny stages unpacked, in plain PyTorch (``canny_edge_tpu/ops/
stages.py``): the path of ``with_intermediates``, ``SobelTorch``, the
``golden`` backend of the command line and the stages of ``--time``.

Every function takes ``(..., H, W)`` tensors and runs where they lie, on the
CPU or on the card, with the same results bit for bit: eager PyTorch rounds
each float32 product and sum on its own and its ``/`` is IEEE, and the rest
is integer arithmetic.  The blur and the gradient are the front end's own
(:mod:`.window`); the magnitude is its exact integer square root.

* blur: int16, the floored renormalized Gaussian;
* :func:`sobel`: magnitude int32 and angle int16 in {0, 45, 90, 135};
* :func:`nonmax_suppression`: int32, off-image neighbours read -32768;
* :func:`hysteresis_with_stats`: the fixed point of masked 8-connected
  dilations, ``steps_per_check`` dilations between two "changed?" tests
  (one host read each on the card), and the dilations run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gaussian import gaussian_kernel
from .thresholds import at_least
from .window import NMS_OOB, blur, isqrt
# int16 (..., H, W) -> int32 (gx, gy), JAX's ``xy_gradient``: gx with clamped
# columns and the off-image row terms dropped, gy with clamped rows and the
# off-image column terms dropped
from .window import sobel as xy_gradient

EDGE = 255
NOEDGE = 0
MODES = ("component", "strict-reference")


# ---------------------------------------------------------------------------
# Stage 1: separable renormalized Gaussian blur
# ---------------------------------------------------------------------------

def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """uint8 (..., H, W) -> int16, with the taps of :func:`gaussian_kernel`."""
    return _gaussian_blur_with_kernel(img, gaussian_kernel(sigma))


def _gaussian_blur_with_kernel(img: torch.Tensor, kernel_vals) -> torch.Tensor:
    """uint8 (..., H, W) -> int16 with the given float32 taps: the blur
    stage's output type, as JAX's (:func:`.window.blur` returns the floored
    values as float32, which the ``smoothed`` intermediate must not be)."""
    return blur(img, kernel_vals).to(torch.int16)


# ---------------------------------------------------------------------------
# Stage 2: Sobel gradient, magnitude and quantized angle
# ---------------------------------------------------------------------------

def quantize_angle(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient direction binned to {0, 45, 90, 135} (int16), exactly.

    The bins of ``atan2(gy, gx)`` in degrees have their edges at
    22.5 + k * 45; in integers, with ``ax = |gx|`` and ``ay = |gy|``:
    below 22.5 when ``ax > ay`` and ``2 ay^2 < (ax - ay)^2``, above 67.5 when
    ``ay > ax`` and ``(ay - ax)^2 > 2 ax^2``.  Between them the sign of
    ``gx * gy`` picks 45 or 135.  ``gx == 0 != gy`` is 90 and ``gx == gy ==
    0`` is 0.  Exact for |g| < 23170 (no int32 overflow).
    """
    gx = gx.to(torch.int32)
    gy = gy.to(torch.int32)
    ax, ay = gx.abs(), gy.abs()
    low = (ax > ay) & (2 * ay * ay < (ax - ay) * (ax - ay))
    high = (ay > ax) & ((ay - ax) * (ay - ax) > 2 * ax * ax)
    mid = ~low & ~high
    sign = gx * gy
    same, opp = sign > 0, sign < 0
    out = torch.zeros_like(gx)
    out = torch.where((gx == 0) & (gy != 0), 90, out)
    out = torch.where(same & mid, 45, out)
    out = torch.where(opp & mid, 135, out)
    out = torch.where((same | opp) & high, 90, out)
    return out.to(torch.int16)


def magnitude(img: torch.Tensor) -> torch.Tensor:
    """int16 (..., H, W) -> int32 ``floor(sqrt(gx^2 + gy^2))``."""
    gx, gy = xy_gradient(img)
    return isqrt(gx * gx + gy * gy)


def sobel(img: torch.Tensor):
    """int16 (..., H, W) -> (magnitude int32, angle int16)."""
    gx, gy = xy_gradient(img)
    return isqrt(gx * gx + gy * gy), quantize_angle(gx, gy)


# ---------------------------------------------------------------------------
# Stage 3: non-max suppression
# ---------------------------------------------------------------------------

def nonmax_suppression(mag: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Keep a pixel above both in-image neighbours along its angle bin."""
    m = mag.to(torch.int32)
    h, w = m.shape[-2:]
    mp = F.pad(m, (1, 1, 1, 1), value=NMS_OOB)

    def nb(dr, dc):
        return mp[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    keep0 = (m > nb(0, -1)) & (m > nb(0, 1))
    keep45 = (m > nb(-1, 1)) & (m > nb(1, -1))
    keep90 = (m > nb(-1, 0)) & (m > nb(1, 0))
    keep135 = (m > nb(-1, -1)) & (m > nb(1, 1))
    keep = torch.where(ang == 0, keep0, torch.where(
        ang == 45, keep45, torch.where(ang == 90, keep90, keep135)))
    return torch.where(keep, m, NOEDGE)


# ---------------------------------------------------------------------------
# Stage 4: hysteresis as a fixed point of masked dilations
# ---------------------------------------------------------------------------

def _dilate8(e: torch.Tensor) -> torch.Tensor:
    """8-connected boolean dilation: along rows, then along columns."""
    h = e.clone()
    h[..., 1:] |= e[..., :-1]
    h[..., :-1] |= e[..., 1:]
    out = h.clone()
    out[..., 1:, :] |= h[..., :-1, :]
    out[..., :-1, :] |= h[..., 1:, :]
    return out


def _strict_reference_fix(new, prev, weak):
    """Re-derive pixel (0, 1) without (1, 0) as a source of promotion.

    The reference BFS lacks the directed edge (1,0)->(0,1)
    (``src/utils.cpp:378,399``).  Nothing to do below 2x2; below three
    columns (0, 2) and (1, 2) do not exist.
    """
    h, w = new.shape[-2:]
    if h < 2 or w < 2:
        return new
    allowed = prev[..., 0, 0] | prev[..., 1, 1]
    if w >= 3:
        allowed = allowed | prev[..., 0, 2] | prev[..., 1, 2]
    new = new.clone()
    new[..., 0, 1] = prev[..., 0, 1] | (weak[..., 0, 1] & allowed)
    return new


def hysteresis(nm, min_val, max_val, steps_per_check: int = 4,
               mode: str = "component") -> torch.Tensor:
    """EDGE (255) on the weak 8-connected components holding a strong pixel.

    ``mode``: "component", or "strict-reference" (the reference binary's
    BFS with its missing (1,0)->(0,1) promotion).
    """
    return hysteresis_with_stats(nm, min_val, max_val, steps_per_check,
                                 mode)[0]


def hysteresis_with_stats(nm, min_val, max_val, steps_per_check: int = 4,
                          mode: str = "component"):
    """Like :func:`hysteresis`, with the dilations run to convergence.

    Rounds of ``steps_per_check`` dilations masked by the weak pixels, from
    the strong ones, until a round changes nothing; the count is ``rounds *
    steps_per_check``, as JAX's ``while_loop`` counts it.  Over a batch the
    test is on the whole batch, as there.
    """
    if mode not in MODES:
        raise ValueError(f"unknown hysteresis mode: {mode!r}")
    strict = mode == "strict-reference"
    weak = at_least(nm, min_val)
    edges = at_least(nm, max_val)
    rounds = 0
    while True:
        new = edges
        for _ in range(steps_per_check):
            stepped = weak & _dilate8(new)
            if strict:
                stepped = _strict_reference_fix(stepped, new, weak)
            new = stepped
        rounds += 1
        if torch.equal(new, edges):
            break
        edges = new
    return edges.to(torch.int16) * EDGE, rounds * steps_per_check
