"""Readers of the entry point's spans (``canny_edge_tpu_torch/utils/
trace.py``), for a benchmark that records them over a traced slice:

- :func:`per_request`: each span's mean host time a request, and the
  request's launches (``k1.launch`` + ``k2.launch`` on the wrappers' path,
  ``plan.launch`` on a launch plan, whose one C call launches K1 and K2)
  against the rest of its ``entry``;
- :func:`split_call`: the card's idle time inside the harness's ``call``
  spans, put down to the innermost program span open at each idle instant;
- :func:`counters` and :func:`moved`: the program's counters (K1's
  launches, the uint16 frames it read, ``u16_frames``, its ring geometry,
  K2's launches, the plans' builds and hits) and how far a slice moved
  them.

The first two take the spans as
:func:`canny_edge_tpu_torch.utils.trace.drain` returns them, with times on
``time.perf_counter()``.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

# the program's counters: module of canny_edge_tpu_torch -> its names
COUNTERS = {
    "kernels.frontend": ("launches", "batch_launches", "u16_frames",
                         "ring_launches", "ring_blocks", "ring_segments",
                         "ring_xpass_rows", "ring_out_rows",
                         "scratch_launches"),
    "kernels.hysteresis_packed": ("launches", "batch_launches"),
    "kernels.plan": ("plan_builds", "plan_hits"),
}


def counters() -> dict[str, int]:
    """The program's counters as they stand, ``{"<module>.<name>": n}``
    (``kernels.frontend.u16_frames``: frames K1 read as uint16, from its
    wrapper's launches and its launch plans')."""
    out = {}
    for mod, names in COUNTERS.items():
        m = importlib.import_module(f"canny_edge_tpu_torch.{mod}")
        for n in names:
            out[f"{mod}.{n}"] = getattr(m, n)
    return out


def moved(before: dict, after: dict) -> dict[str, int]:
    """How far each counter moved from ``before`` to ``after`` (both of
    :func:`counters`)."""
    return {k: after[k] - before[k] for k in after}


def per_request(spans) -> dict:
    """Mean host ms a request (an ``entry`` root) of each span, of the
    request's ``*.launch`` children (``entry_launch_ms``) and of the rest
    of ``entry`` (``entry_prep_ms``)."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            kids[s.parent].append(s)
    roots = [i for i, s in enumerate(spans)
             if s.parent == -1 and s.name == "entry"]
    by_name, launch, prep = defaultdict(float), 0.0, 0.0
    for r in roots:
        e = spans[r]
        by_name["entry"] += e.end - e.start
        own = sum(k.end - k.start for k in kids[r]
                  if k.name.endswith(".launch"))
        launch += own
        prep += e.end - e.start - own
        for k in kids[r]:
            by_name[k.name] += k.end - k.start
    n = max(1, len(roots))
    return {"requests": len(roots),
            "per_request_ms": {k: v / n * 1e3 for k, v in by_name.items()},
            "entry_launch_ms": launch / n * 1e3,
            "entry_prep_ms": prep / n * 1e3}


def split_call(gaps, calls, spans) -> dict[str, float]:
    """The idle time that lies inside ``calls`` by the innermost program
    span open at each instant: ``{"call/<span>": s}``, and ``{"call": s}``
    for what no span covers.  ``gaps``: the card's idle intervals,
    ``calls``: the harness's call intervals, both ``(start, end)`` on the
    spans' clock.  The entries add up to the idle time inside the calls."""
    depth = []
    for s in spans:
        depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
    order = sorted(range(len(spans)), key=lambda i: spans[i].start)
    starts = [spans[i].start for i in order]
    longest = max((s.end - s.start for s in spans), default=0.0)
    calls = sorted(calls)
    call_starts = [s for s, _ in calls]
    out: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        j = max(0, bisect.bisect_right(call_starts, a) - 1)
        while j < len(calls) and calls[j][0] < b:
            x, y = max(a, calls[j][0]), min(b, calls[j][1])
            j += 1
            if y <= x:
                continue
            lo = bisect.bisect_left(starts, x - longest)
            cand = [order[k] for k in range(lo, bisect.bisect_left(starts, y))
                    if spans[order[k]].end > x]
            cuts = sorted({x, y, *(t for i in cand for t in
                                   (spans[i].start, spans[i].end)
                                   if x < t < y)})
            for u, v in zip(cuts, cuts[1:]):
                m = (u + v) / 2
                inner = [i for i in cand
                         if spans[i].start <= m < spans[i].end]
                i = max(inner, key=lambda i: depth[i], default=None)
                out["call" if i is None else "call/" + spans[i].name] += v - u
    return dict(out)
