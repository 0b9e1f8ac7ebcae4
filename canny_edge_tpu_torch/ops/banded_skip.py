"""Plain mirror of the K4 kernel's step-skipping rule.

The card's banded engine (``kernels/csrc/hysteresis_banded.cu``) runs the
recurrence of :mod:`.banded` (forward pass over band rows 1..band_h+1,
backward pass over band_h..1, rounds while a dilation step would still add
a pixel to the band's interior), but after a band's first round it runs
``step(r, nb)`` only if the neighbour row ``nb`` changed since that step
last ran: in the pass before this one, or earlier in this pass.  A row that
has been stepped once is closed under its own row flood and already holds
the growth from its neighbour as the neighbour was then, so a skipped step
would have returned the row unchanged.

This module runs that rule with the whole-tensor operators of
:mod:`.banded`, all bands at once, and with ``skip=False`` the same loop
with every step run.  It is the CPU check that the rule changes no state:
after every round of every sweep the bands equal those of the full loop, so
rounds, sweeps and the result equal :func:`.banded.hysteresis_banded`'s.
"""

from __future__ import annotations

import torch

from .banded import _growth, _shift, _to_bands, band_params, hflood
from .packed import cdiv
from .thresholds import at_least


def hysteresis_banded_skip(nm: torch.Tensor, min_val: int, max_val: int, *,
                           band_h=None, group=None, skip: bool = True):
    """int NMS magnitude (H, W) -> ``(edges int16 {0, 255}, sweeps, stats)``.

    ``stats``: ``rounds`` (one list a sweep: the rounds of each band),
    ``steps`` (row steps run, over all bands, rounds and sweeps) and
    ``states`` (the bands ``(nb, band_h + 2, W)`` after every round, in
    order).  ``skip=False`` runs every step of every active band.
    """
    h, w = nm.shape
    band_h, _ = band_params(h, w, band_h, group)
    nb = cdiv(h, band_h)
    rows = band_h + 2
    weak = at_least(nm, min_val)
    weak_b = _to_bands(weak, band_h, nb)
    stats = {"rounds": [], "steps": 0, "states": []}

    def step(e, r, nbr, run):
        """Row r of the bands in ``run`` from neighbour row nbr; returns the
        bands whose row changed."""
        wr, nr = weak_b[:, r], e[:, nbr]
        grow = nr | _shift(nr, 1) | _shift(nr, -1)
        cur = torch.where(run[:, None], hflood(e[:, r] | (grow & wr), wr),
                          e[:, r])
        changed = (cur != e[:, r]).any(1)
        e[:, r] = cur
        stats["steps"] += int(run.sum())
        return changed

    def sweep(edges):
        e = _to_bands(edges, band_h, nb).clone()
        active = torch.ones(nb, dtype=torch.bool, device=nm.device)
        rounds = torch.zeros(nb, dtype=torch.int64, device=nm.device)
        # row changed in the last forward / backward pass of its band
        in_fwd = torch.zeros((nb, rows), dtype=torch.bool, device=nm.device)
        in_bwd = torch.zeros_like(in_fwd)
        every = torch.ones_like(active)      # round 1 runs every step
        while True:
            now = torch.zeros_like(in_fwd)
            moved = torch.zeros_like(active)
            for r in range(1, band_h + 2):
                moved = step(e, r, r - 1,
                             active & (every | moved | in_bwd[:, r - 1]))
                now[:, r] = moved
            in_fwd = torch.where(active[:, None], now, in_fwd)
            now = torch.zeros_like(in_fwd)
            moved = torch.zeros_like(active)
            for r in range(band_h, 0, -1):
                moved = step(e, r, r + 1,
                             active & (every | moved | in_fwd[:, r + 1]))
                now[:, r] = moved
            in_bwd = torch.where(active[:, None], now, in_bwd)
            rounds += active
            stats["states"].append(e.clone())
            active = active & _growth(e, weak_b)[:, 1:-1].flatten(1).any(1)
            if skip:
                every = torch.zeros_like(active)
            if not bool(active.any()):
                break
        stats["rounds"].append(rounds.tolist())
        return e[:, 1:-1].reshape(nb * band_h, w)[:h]

    edges = sweep(at_least(nm, max_val))
    sweeps = 1
    while bool(_growth(edges, weak).any()):
        edges = sweep(edges)
        sweeps += 1
    return edges.to(torch.int16) * 255, sweeps, stats
