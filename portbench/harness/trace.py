"""The traced slice of a ``--trace 1`` run.

The profiler (``torch.profiler``: on the card its device activity and the
runtime calls, not the host's operators, whose recording would slow the
calls it measures) runs over a bounded slice of the window, started and stopped by the driver at request
boundaries; its events stay in memory until the window has closed, and the
Chrome trace it writes goes to the temporary directory and is deleted once
read.  The harness's own host spans of the main thread (``call``,
``wait``, ``next``) are ``perf_counter`` intervals; a profiler event recorded at a known ``perf_counter`` time
(the anchor) maps the trace's clock onto them.

A device operation is a trace event of the categories ``kernel``,
``gpu_memcpy`` or ``gpu_memset``.  ``busy_s`` is the union of their
intervals within the slice.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass

from portbench.harness import device as cores

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "portbench.anchor"              # on the CPU: a named region
ANCHOR_CUDA = "cudaDeviceSynchronize"     # on the card: the runtime call


@dataclass
class Trace:
    t0: float
    t1: float
    ops: list        # (name, category, start, end), clipped to the slice
    spans: list      # (label, start, end) the main thread's host spans
    requests: int    # requests whose work lies in the slice

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, _, s, e in self.ops if match(n))

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out = []
        for _, _, s, e in sorted(self.ops, key=lambda o: o[2]):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())


class Tracer:
    """Profiles one slice: :meth:`start`, :meth:`stop`, then, once the
    window has closed, :meth:`collect`.  ``enabled`` False makes every call
    a no-op (the untraced run)."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.after_s = 0.0            # into the window, where it starts
        self.active = False
        self.done = False
        self.spans: list = []         # the main thread's
        self._prof = None
        self._anchor = None
        self.t0 = self.t1 = None

    def span(self, label: str, start: float, end: float) -> None:
        """A host span of the main thread, kept while the slice runs."""
        if self.active:
            self.spans.append((label, start, end))

    def warm(self) -> None:
        """A throwaway profile, in set-up: the profiler's first start (and
        the card's tracing library) costs seconds, which would otherwise
        fall into the window and the slice."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU]
        with profile(activities=acts):
            x = torch.ones(1024, device="cuda" if self.cuda else "cpu")
            x.add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def start(self) -> None:
        """Start the profiler, then the anchor: on the card a
        ``torch.cuda.synchronize()`` between two host clock readings, whose
        runtime call the trace records (the host's own operations are not
        profiled there, so the calls in the slice run at their speed); on
        the CPU a named region."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                             else [ProfilerActivity.CPU])
        cores.pin("rest")     # whatever threads the profiler starts
        self._prof.start()
        cores.pin("main")
        a = time.perf_counter()
        if self.cuda:
            torch.cuda.synchronize()
        else:
            with record_function(ANCHOR):
                pass
        self._anchor = (a + time.perf_counter()) / 2
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.active = False
        self.done = True
        self._prof.stop()

    def collect(self, requests: int) -> Trace | None:
        """The slice's :class:`Trace`, or None when no slice was taken."""
        if not self.done:
            return None
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        name = ANCHOR_CUDA if self.cuda else ANCHOR
        anchor = sorted((e for e in events if e.get("ph") == "X"
                         and name in str(e.get("name", ""))),
                        key=lambda e: e["ts"])
        if not anchor:
            raise RuntimeError("the profiler lost the anchor event: its "
                               "trace cannot be placed on the host's clock")
        a = anchor[0]
        shift = self._anchor - (a["ts"] + a.get("dur", 0) / 2) / 1e6
        ops = []
        for e in events:
            if e.get("ph") != "X" or \
                    str(e.get("cat", "")).lower() not in DEVICE_CATS:
                continue
            s = e["ts"] / 1e6 + shift
            end = s + e.get("dur", 0) / 1e6
            s, end = max(s, self.t0), min(end, self.t1)
            if end > s:
                ops.append((e.get("name", "?"), e["cat"].lower(), s, end))
        return Trace(self.t0, self.t1, ops, self.spans, requests)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    main thread's host span it fell in (``harness`` where it was in none).
    The main thread's spans follow one another, so each idle instant has at
    most one."""
    by_op: dict[str, float] = {}
    for n, _, s, e in trace.ops:
        by_op[n] = by_op.get(n, 0.0) + e - s
    gaps, t = [], trace.t0
    for s, e in trace.busy_intervals():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.t1 > t:
        gaps.append((t, trace.t1))
    by_span: dict[str, float] = {}
    spans = sorted(trace.spans, key=lambda x: x[1])
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < b:
            lab, s, e = spans[k]
            o = min(b, e) - max(a, s)
            if o > 0:
                by_span[lab] = by_span.get(lab, 0.0) + o
                covered += o
            k += 1
        if b - a - covered > 0:
            by_span["harness"] = by_span.get("harness", 0.0) + b - a - covered

    def ranked(d):
        return [[k[:96], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}


def idle_pct(trace: Trace | None) -> float | None:
    """100 less the device's busy share of the slice; None without a slice
    or where no device operation was recorded."""
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
