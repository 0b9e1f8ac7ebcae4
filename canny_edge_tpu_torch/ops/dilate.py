"""Plain tiled-dilation hysteresis (K3's plain version).

The function of ``canny_edge_tpu/kernels/hysteresis.py:hysteresis_pallas``
(the ``hysteresis_impl="dilate"`` engine), written with whole-tensor
PyTorch ops:

* the image is cut into ``(th, tw)`` tiles (:func:`tile_shape`, the JAX
  rule), each read with a zero-padded 1-pixel halo;
* a sweep dilates every tile (halo included) to its local fixed point,
  ``e = weak & dilate3x3(e)``, all tiles at once, and keeps the tile
  interiors; every tile reads the *pre-sweep* state;
* sweep 0 always runs, then sweeps run until one changes nothing.

The result is the set of weak pixels 8-connected to a seed.  The seeds are
``nm >= max(min_val, max_val)``: equal to ``nm >= max_val`` when
``max_val >= min_val``; otherwise every weak pixel is a seed, and the JAX
kernel's first dilation also yields every weak pixel.  Each sweep's output
is the tiles' unique local fixed points, so the sweep count does not depend
on how a tile gets there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.constants import K3_TILE
from .packed import cdiv
from .thresholds import at_least

DEFAULT_TILE = K3_TILE


def tile_shape(h: int, w: int, tile=DEFAULT_TILE) -> tuple[int, int]:
    """The tile of ``hysteresis_pallas``: ``(min(tile[0], max(8, H)),
    min(tile[1], max(128, W)))``."""
    th, tw = int(tile[0]), int(tile[1])
    if th < 1 or tw < 1:
        raise ValueError(f"tile must be positive, got {tuple(tile)}")
    return min(th, max(8, h)), min(tw, max(128, w))


def halo_tiles(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W) -> (nty, ntx, th + 2, tw + 2) tiles with a 1-pixel halo; the
    image is zero-padded by 1 plus the slack up to whole tiles
    (``kernels/frontend.py:make_halo_tiles`` with r = 1)."""
    h, w = x.shape
    nty, ntx = cdiv(h, th), cdiv(w, tw)
    padded = F.pad(x, (1, ntx * tw - w + 1, 1, nty * th - h + 1))
    return padded.unfold(0, th + 2, th).unfold(1, tw + 2, tw)


def dilate3x3(e: torch.Tensor) -> torch.Tensor:
    """8-connected OR-dilation over the last two axes, zero outside."""
    h = e.clone()
    h[..., :, 1:] |= e[..., :, :-1]
    h[..., :, :-1] |= e[..., :, 1:]
    v = h.clone()
    v[..., 1:, :] |= h[..., :-1, :]
    v[..., :-1, :] |= h[..., 1:, :]
    return v


def hysteresis_dilate(nm: torch.Tensor, min_val: int, max_val: int, *,
                      tile=DEFAULT_TILE, return_sweeps: bool = False):
    """int NMS magnitude (H, W) -> int16 {0, 255}; with ``return_sweeps``
    also the number of sweeps run."""
    h, w = nm.shape
    th, tw = tile_shape(h, w, tile)
    nty, ntx = cdiv(h, th), cdiv(w, tw)
    weak = at_least(nm, min_val)
    weak_t = halo_tiles(weak, th, tw)

    def sweep(edges):
        e = halo_tiles(edges, th, tw)
        while True:
            new = weak_t & dilate3x3(e)
            if torch.equal(new, e):
                break
            e = new
        inner = e[:, :, 1:-1, 1:-1].permute(0, 2, 1, 3)
        return inner.reshape(nty * th, ntx * tw)[:h, :w]

    edges = sweep(weak & at_least(nm, max_val))
    sweeps = 1
    while True:
        new = sweep(edges)
        sweeps += 1
        if torch.equal(new, edges):
            break
        edges = new
    out = edges.to(torch.int16) * 255
    return (out, sweeps) if return_sweeps else out
