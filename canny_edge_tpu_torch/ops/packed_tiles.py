"""Plain mirror of the K2 kernel's tile schedule: the dirty-tile worklist.

The card's flood (``kernels/csrc/hysteresis_packed.cu``) cuts the packed
masks into tiles of ``rows x words`` words and runs in grid-wide steps:

* step 0 floods every tile from the strong mask itself (own words and the
  one-word / one-row halo of the adjacent tiles), so its first dilation is
  the plain flood's prologue ``weak & dilate8(strong)``;
* every later step floods only the dirty tiles, each from the edges of the
  step before, to its local fixed point;
* a tile whose top row, bottom row, first or last word column changed
  against what its neighbours assumed marks those neighbours dirty for the
  next step; the flood stops after the first step that marks nothing.

This module runs that schedule with the operators of :mod:`.packed` on whole
batches of tile windows, every tile reading the state before the step.  It
is the CPU check that the schedule reaches the fixed point of
:func:`.packed.hysteresis_packed_masks` at ragged shapes, and the oracle of
the kernel's step count: a tile on the card may also see a neighbour's
writes of the same step, which can only save steps, so the kernel takes at
most as many steps as this mirror.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.constants import K2_TILE
from .packed import (cdiv, dilate_packed, from_words, hflood,
                     strict_fix_packed, to_words, vflood)

DEFAULT_TILE = K2_TILE      # the kernel's tile: 8 rows x 32 words


def _local_fixed_point(win, weak_own, fix_at):
    """Flood a batch of tile windows ``(n, rows+2, words+2)`` in place.

    The halo ring stays as it is; ``weak_own`` is the weak mask with the
    ring zeroed, so only own words change.  ``fix_at``: None, or ``(i, row,
    word)``: window i holds pixel (0, 1) at that row and word of the window
    and takes the strict fix (which may read the ring's row below).
    """
    rows, words = win.shape[-2] - 2, win.shape[-1] - 2
    ring = win.clone()
    ring[:, 1:-1, 1:-1] = 0
    wk_own = weak_own[:, 1:-1, 1:-1]
    while True:
        d = dilate_packed(win, weak_own)
        if fix_at is not None:
            i, r, w = fix_at
            d[i] = strict_fix_packed(d[i], win[i], weak_own[i], r, w)
        own = vflood(hflood(d[:, 1:-1, 1:-1], wk_own, 32 * words), wk_own, rows)
        new = ring.clone()
        new[:, 1:-1, 1:-1] = own
        if torch.equal(new, win):
            return win
        win = new


def hysteresis_packed_tiles(weak_p, strong_p, height: int, width: int, *,
                            tile=DEFAULT_TILE, strict: bool = False,
                            quirk_rw=(0, 0)):
    """Packed uint32 weak/strong masks -> ``(edges, steps, floods)``.

    ``edges``: the packed edge mask, equal to
    :func:`.packed.hysteresis_packed_masks`'s whatever the tile.  ``steps``:
    grid-wide steps until one marks no tile.  ``floods``: tile floods run
    (all tiles in step 0, the dirty ones after).  ``tile``: ``(rows,
    words)``; strict mode needs ``rows >= 2``.  ``quirk_rw``: the (row, word)
    of the strict fix, as in :func:`.packed.hysteresis_packed_masks`.
    """
    rows, words = tile
    if rows < 1 or words < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    strict = strict and height >= 2 and width >= 2
    if strict and rows < 2:
        raise ValueError("strict mode needs tiles of at least 2 rows")
    weak, strong = from_words(weak_p), from_words(strong_p)
    h, wd = weak.shape
    nty, ntx = cdiv(h, rows), cdiv(wd, words)
    hp, wp = nty * rows, ntx * words

    def windows(x):
        """(h, wd) -> (nty, ntx, rows+2, words+2) overlapping tile windows."""
        x = F.pad(x, (1, wp - wd + 1, 1, hp - h + 1))
        return x.unfold(0, rows + 2, rows).unfold(1, words + 2, words)

    def tiles(x):
        """(nty, ntx, rows, words) own words -> (h, wd)."""
        return x.permute(0, 2, 1, 3).reshape(hp, wp)[:h, :wd]

    weak_own = windows(weak).clone()
    weak_own[..., 0, :] = 0
    weak_own[..., -1, :] = 0
    weak_own[..., :, 0] = 0
    weak_own[..., :, -1] = 0
    state = weak & strong                  # what the neighbours assume
    dirty = torch.ones((nty, ntx), dtype=torch.bool, device=weak.device)
    qr, qw = quirk_rw
    qt = (qr // rows) * ntx + qw // words      # the tile of the strict fix
    steps = floods = 0
    while True:
        src = strong if steps == 0 else state
        fix_at = None
        if strict and bool(dirty.flatten()[qt]):
            fix_at = (int(dirty.flatten()[:qt].sum()), qr % rows + 1,
                      qw % words + 1)
        win = _local_fixed_point(windows(src)[dirty], weak_own[dirty], fix_at)
        new = windows(state)[..., 1:-1, 1:-1].clone()
        old = new[dirty]
        own = win[:, 1:-1, 1:-1]
        new[dirty] = own
        state = tiles(new)
        floods += int(dirty.sum())
        steps += 1
        # border changes mark the adjacent tiles for the next step
        marks = torch.zeros((nty + 2, ntx + 2), dtype=torch.bool,
                            device=weak.device)

        def changed(a, b):
            full = torch.zeros((nty, ntx), dtype=torch.bool, device=weak.device)
            full[dirty] = (a != b).flatten(1).any(1)
            return full

        top = changed(own[:, 0], old[:, 0])
        bottom = changed(own[:, -1], old[:, -1])
        for dx in range(3):
            marks[0:nty, dx:dx + ntx] |= top
            marks[2:nty + 2, dx:dx + ntx] |= bottom
        marks[1:nty + 1, 0:ntx] |= changed(own[:, :, 0], old[:, :, 0])
        marks[1:nty + 1, 2:ntx + 2] |= changed(own[:, :, -1], old[:, :, -1])
        dirty = marks[1:-1, 1:-1]
        if not bool(dirty.any()):
            return to_words(state), steps, floods
