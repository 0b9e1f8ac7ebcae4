"""Plain banded raster-scan hysteresis (K4's plain version).

The function of ``canny_edge_tpu/kernels/hysteresis_v2.py:hysteresis_banded``
(the ``hysteresis_impl="banded"`` engine), written with whole-tensor
PyTorch ops, all bands at once:

* the image is cut into full-width bands of ``band_h`` rows, each read
  with a 1-row halo above and below from the pre-sweep state (zeros
  outside the image);
* a round is a forward row recurrence over band rows 1..band_h+1 and a
  backward one over band_h..1: each row grows from its neighbour row
  (diagonals included), then floods its weak runs (:func:`hflood`, the
  segmented or-scan ``_hflood``);
* each band repeats rounds while one dilation step would still add a pixel
  to its interior (``pending_growth``), then keeps its interior;
* sweep 0 always runs, then sweeps run while one dilation step would add a
  pixel anywhere (``needs_more``).

Each band runs its own rounds, as with ``group=1``.  The JAX kernel runs
the rounds of a group of bands until all of them settle; an extra round can
only add connected weak pixels, so ``group`` changes the sweep count at most,
never the result: the weak pixels 8-connected to a strong one, plus the
strong pixels themselves.
"""

from __future__ import annotations

import torch

from .dilate import dilate3x3
from .packed import cdiv
from .thresholds import at_least


def band_params(h: int, w: int, band_h=None, group=None) -> tuple[int, int]:
    """``(band_h, group)`` as ``hysteresis_banded`` chooses and clamps them.

    ``group`` (bands per TPU grid step, sized to its VMEM) is validated and
    returned; no result depends on it.
    """
    if band_h is None:
        band_h = 64 if h >= 512 else max(8, h)
    if int(band_h) < 1:
        raise ValueError(f"band_h must be >= 1, got {band_h}")
    band_h = min(int(band_h), max(8, h))
    nb = cdiv(h, band_h)
    if group is None:
        per_band = (band_h + 2) * w * 16
        group = max(1, min(nb, int(15e6 // per_band)))
    if int(group) < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return band_h, min(int(group), nb)


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[..., c] = x[..., c - s] along the last axis, zero fill (s may be < 0)."""
    out = torch.zeros_like(x)
    n = x.shape[-1]
    if abs(s) < n:
        if s > 0:
            out[..., s:] = x[..., :n - s]
        else:
            out[..., :n + s] = x[..., -s:]
    return out


def hflood(cur: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Flood ``cur`` along entire weak runs of ``w`` in each row, both ways
    (log-step doubling of the transfer function ``t(x) = a | (b & x)``)."""
    width = cur.shape[-1]
    a_l, b_l = cur, w
    a_r, b_r = cur, w
    s = 1
    while s < width:
        a_l = a_l | (b_l & _shift(a_l, s))
        b_l = b_l & _shift(b_l, s)
        a_r = a_r | (b_r & _shift(a_r, -s))
        b_r = b_r & _shift(b_r, -s)
        s *= 2
    return (w & (a_l | a_r)) | cur


def _growth(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pixels that one dilation step would add."""
    return w & dilate3x3(e) & ~e


def _to_bands(x: torch.Tensor, band_h: int, nb: int) -> torch.Tensor:
    """(H, W) -> (nb, band_h + 2, W) with 1-row halos, zero outside."""
    h, w = x.shape
    padded = torch.zeros((nb * band_h + 2, w), dtype=x.dtype, device=x.device)
    padded[1:h + 1] = x
    return padded.unfold(0, band_h + 2, band_h).permute(0, 2, 1)


def hysteresis_banded(nm: torch.Tensor, min_val: int, max_val: int, *,
                      band_h=None, group=None, return_sweeps: bool = False):
    """int NMS magnitude (H, W) -> int16 {0, 255}; with ``return_sweeps``
    also the number of sweeps run."""
    h, w = nm.shape
    band_h, _ = band_params(h, w, band_h, group)
    nb = cdiv(h, band_h)
    weak = at_least(nm, min_val)
    weak_b = _to_bands(weak, band_h, nb)

    def step(e, r, nbr):
        wr, nr = weak_b[:, r], e[:, nbr]
        grow = nr | _shift(nr, 1) | _shift(nr, -1)
        e[:, r] = hflood(e[:, r] | (grow & wr), wr)

    def sweep(edges):
        e = _to_bands(edges, band_h, nb).clone()
        active = torch.ones(nb, dtype=torch.bool, device=nm.device)
        while True:
            new = e.clone()
            for r in range(1, band_h + 2):
                step(new, r, r - 1)
            for r in range(band_h, 0, -1):
                step(new, r, r + 1)
            e = torch.where(active[:, None, None], new, e)
            active &= _growth(e, weak_b)[:, 1:-1].flatten(1).any(1)
            if not bool(active.any()):
                break
        return e[:, 1:-1].reshape(nb * band_h, w)[:h]

    edges = sweep(at_least(nm, max_val))
    sweeps = 1
    while bool(_growth(edges, weak).any()):
        edges = sweep(edges)
        sweeps += 1
    out = edges.to(torch.int16) * 255
    return (out, sweeps) if return_sweeps else out
