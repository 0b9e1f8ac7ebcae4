"""Plain mirror of the K3 kernel's sweep schedule: the dirty-tile rule.

The card's tiled-dilation engine (``kernels/csrc/hysteresis_dilate.cu``)
keeps the edge mask in a pair of buffers: sweep ``i`` reads buffer ``i % 2``
and writes the other, which still holds the state of two sweeps ago (zeros
before sweep 1).  Sweeps 0 and 1 flood every tile; from sweep 2 on a tile is
flooded only if it or one of its 8 neighbours changed in the sweep before:

* no pixel of a skipped tile's window changed in sweep ``i - 1``, so its
  output in sweep ``i`` is its output in sweep ``i - 1``;
* its own interior did not change in sweep ``i - 1`` either, so the write
  buffer already holds that output.

This module runs that schedule, buffers and all, with the operators of
:mod:`.dilate`, and with ``skip=False`` every tile in every sweep.  It is the
CPU check that the rule changes no state: the write buffer after every sweep
equals the full schedule's, so sweeps and result equal
:func:`.dilate.hysteresis_dilate`'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dilate import DEFAULT_TILE, dilate3x3, halo_tiles, tile_shape
from .packed import cdiv
from .thresholds import at_least


def hysteresis_dilate_tiles(nm: torch.Tensor, min_val: int, max_val: int, *,
                            tile=DEFAULT_TILE, skip: bool = True):
    """int NMS magnitude (H, W) -> ``(edges int16 {0, 255}, sweeps, stats)``.

    ``stats``: ``floods`` (tile floods run, one entry a sweep) and ``states``
    (the written buffer after every sweep).  ``skip=False`` floods every
    tile in every sweep.
    """
    h, w = nm.shape
    th, tw = tile_shape(h, w, tile)
    nty, ntx = cdiv(h, th), cdiv(w, tw)
    weak = at_least(nm, min_val)
    weak_t = halo_tiles(weak, th, tw)
    stats = {"floods": [], "states": []}

    def interiors(x):
        """(H, W) -> (nty, ntx, th, tw) tile interiors, zero past the image."""
        x = F.pad(x, (0, ntx * tw - w, 0, nty * th - h))
        return x.reshape(nty, th, ntx, tw).permute(0, 2, 1, 3)

    def image(t):
        return t.permute(0, 2, 1, 3).reshape(nty * th, ntx * tw)[:h, :w]

    # seeds nm >= max(min_val, max_val), masked by weak: see ops/dilate.py
    bufs = [weak & at_least(nm, max_val), torch.zeros_like(weak)]
    changed = torch.ones((nty, ntx), dtype=torch.bool, device=nm.device)
    sweep = 0
    while True:
        src, dst = bufs[sweep % 2], bufs[(sweep + 1) % 2]
        run = torch.ones_like(changed)
        if skip and sweep >= 2:          # it or a neighbour changed
            run = dilate3x3(changed)
        e = halo_tiles(src, th, tw)[run]
        wk = weak_t[run]
        while True:
            new = wk & dilate3x3(e)
            if torch.equal(new, e):
                break
            e = new
        out = interiors(dst).clone()
        out[run] = e[:, 1:-1, 1:-1]
        changed = torch.zeros_like(changed)
        changed[run] = (out[run] != interiors(src)[run]).flatten(1).any(1)
        bufs[(sweep + 1) % 2] = image(out)
        stats["floods"].append(int(run.sum()))
        stats["states"].append(bufs[(sweep + 1) % 2])
        sweep += 1
        if sweep >= 2 and not bool(changed.any()):
            break
    return bufs[sweep % 2].to(torch.int16) * 255, sweep, stats
