"""Tracing of the port: a ``torch.profiler`` capture around any pipeline
call (``canny_edge_tpu/utils/trace.py``), a Chrome trace viewable in
Perfetto, with the card's kernels when the trace is on the card; and the
port's own span recorder, whose spans :func:`trace` writes beside them.

The recorder keeps host spans of the entry point in memory: each has a
name, a start and an end on ``time.perf_counter()``, the index of its
parent span and a request id, the sequence number of the request's root
span.  The entry points, the K1/K2 wrappers and the launch plans open
these spans (a request of ``CannyTorch`` on the ``fused`` backend)::

    entry             the request: CannyTorch.__call__/.packed/.batch/
                      .batch_packed, or canny_fn* called on their own
      entry.check     validation, thresholds, mode and backend, the input
                      on the device, the empty-input test
    a request on its launch plan (kernels/plan.py; on the card):
      plan.prep       the plan's lookup (or whether one applies, and its
                      build), the output, the token
      plan.launch     the one ctypes call that launches K1 then K2, and
                      its error check
    every other request (on a CPU tensor, the plain versions):
      k1.prep         K1's wrapper: bounds, checks, path, outputs, library,
                      device guard, stream
      k1.launch       the ctypes call into K1 and its error check (on a
                      CPU tensor: the plain front end)
      k2.prep         K2's wrapper: checks, scratch, buffers, the output
      k2.launch       the ctypes call into K2 and its error check (on a
                      CPU tensor: the plain flood)

The taps' ``.to`` and the function's own checks, after ``entry.check``,
and a plan's next output, made after ``plan.launch``, are ``entry``'s own
time; :func:`annotate` adds spans of
its own.  A span that an exception cuts short is not recorded (the
request's ``entry`` is).  Recording is off by default, and off a span site
costs one test of :data:`RECORDING`.  :func:`start_recording` turns it on
for every thread (each thread's spans nest on their own),
:func:`stop_recording` off, and :func:`drain` takes the spans out.  The
buffer holds ``capacity`` spans; spans past it are counted, not kept.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import warnings
from threading import get_ident
from time import perf_counter
from typing import NamedTuple

# read by every span site; set only by start_recording / stop_recording
RECORDING = False
CAPACITY = 1 << 17       # spans between two drains, by default

ANCHOR = "canny_edge_tpu_torch.anchor"
SPAN_TID = 1 << 30       # the spans' track in a Chrome trace


class Span(NamedTuple):
    name: str
    start: float         # time.perf_counter() seconds
    end: float
    parent: int          # index in the drained list, -1 for a root
    request: int         # the root's sequence number


# A span is recorded when it closes, as (name, start, end, thread); its
# parent and request are worked out when it is drained, from how the spans
# of each thread nest.  list.append is atomic under the GIL.
_spans: list = []
_capacity = 0
_dropped = 0
_requests = itertools.count()
_local = threading.local()           # .entry: an entry span is open

# the start of a span: ``sp = trace.RECORDING and trace.begin()``, then
# ``if sp: trace.end(name, sp)``
begin = perf_counter


def start_recording(capacity: int = CAPACITY) -> None:
    """Record spans from now on, into an empty buffer of ``capacity``
    spans (what an earlier recording left is dropped)."""
    global RECORDING
    if capacity < 1:
        raise ValueError(f"capacity {capacity} < 1")
    _reset(capacity)
    RECORDING = True


def stop_recording() -> None:
    """Record no more spans; a span already open still closes."""
    global RECORDING
    RECORDING = False


def end(name: str, start: float) -> None:
    """Record span ``name`` from ``start`` (its :func:`begin`) to now."""
    global _dropped
    if len(_spans) < _capacity:
        _spans.append((name, start, perf_counter(), get_ident()))
    else:
        _dropped += 1


def entry() -> float | None:
    """The start of the request's root span, ``entry``, or None where this
    thread has one open already (a model method calling a ``canny_fn*``).
    Close it with :func:`end_entry`."""
    if getattr(_local, "entry", False):
        return None
    _local.entry = True
    return perf_counter()


def end_entry(start: float) -> None:
    """Close the root span that :func:`entry` opened at ``start``."""
    _local.entry = False
    end("entry", start)


def drain() -> tuple[list[Span], int]:
    """``(spans, dropped)``: the spans closed since recording started or
    the last drain, in the order they opened (a parent before its
    children), and the number that did not fit the buffer; the buffer is
    then empty.  A span's parent is the innermost span of its thread that
    holds it; a span that closed after the buffer filled is dropped, so a
    request's children may outlive their root there."""
    recs, dropped = _spans, _dropped
    _reset(_capacity)
    return _nest(recs, _requests), dropped


def _nest(recs: list, requests) -> list[Span]:
    """Records ``(name, start, end, thread)`` as spans, their parents and
    request ids (drawn from ``requests``) worked out from how each thread's
    records nest."""
    recs = sorted(recs, key=lambda r: (r[1], -r[2]))
    spans, open_ = [], {}          # thread -> [(end, index, request)]
    for name, start, stop, thread in recs:
        st = open_.setdefault(thread, [])
        while st and st[-1][0] <= start:
            st.pop()
        parent, request = st[-1][1:] if st else (-1, next(requests))
        st.append((stop, len(spans), request))
        spans.append(Span(name, start, stop, parent, request))
    return spans


def _reset(capacity: int) -> None:
    global _spans, _capacity, _dropped
    _spans = []
    _capacity = capacity
    _dropped = 0


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a ``record_function`` region inside a trace, and a
    span of the recorder while it records."""
    from torch.profiler import record_function

    sp = RECORDING and begin()
    try:
        with record_function(name):
            yield
    finally:
        if sp:
            end(name, sp)


@contextlib.contextmanager
def trace(out_dir: str | None = None, device="cuda"):
    """Trace the enclosed block into ``out_dir/trace.json``, with the
    recorder on (turned on for the block, and drained after it, unless the
    caller is recording already: then the block's spans are copied, the
    recording goes on, and their request ids count from 0 in the file).
    The spans are complete events of the category
    ``canny_span`` (``args``: ``request``, ``parent``), on a track of their
    own beside the host's operators and the card's kernels, placed on the
    profiler's clock by a line through two anchors: named regions timed on
    ``perf_counter``, the quickest of three before the block and of three
    after it (the profiler's first region, which is not one of them, can
    cost the host a millisecond; a slow one would put its anchor off by
    half its time).  Where the profiler loses one of those regions, the
    file holds no spans, with a warning.

    ``device``: "cuda" (default; the host and the card, ``RuntimeError``
    without one) or "cpu" (the host only).  ``out_dir`` defaults to
    ``canny_torch_trace`` in the temporary directory.  Yields ``out_dir``::

        with trace("traces/run1"):
            model(img, 50, 150)
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..kernels.fused import resolve_device

    def anchors() -> list[tuple[float, float]]:
        out = []
        for _ in range(3):
            a = perf_counter()
            with record_function(ANCHOR):
                pass
            b = perf_counter()
            out.append(((a + b) / 2, b - a))
        return out

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                      "canny_torch_trace")
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(ANCHOR + ".warm"):
            pass
        first = anchors()
        own = not RECORDING
        if own:
            start_recording()
        buf, mark, dropped = _spans, len(_spans), _dropped
        try:
            yield out_dir
        finally:
            if own:
                stop_recording()
            last = anchors()
    if own:
        spans, dropped = drain()
    elif _spans is buf:            # the caller's recording: copied, kept
        spans, dropped = _nest(buf[mark:], itertools.count()), \
            _dropped - dropped
    else:                          # drained inside the block: not ours
        spans, dropped = [], 0
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    try:
        events += span_events(spans, (first, last), events, dropped)
    except RuntimeError as e:
        warnings.warn(f"{e}; {path} holds no spans")
        return
    with open(path, "w") as f:
        json.dump(doc, f)


def span_events(spans: list[Span], anchors, events: list,
                dropped: int = 0) -> list[dict]:
    """The recorder's spans as Chrome trace events on the clock of
    ``events``.  ``anchors``: two groups of ``(perf_counter time, host
    duration)``, one for each of the named regions :data:`ANCHOR` of
    ``events``, in order; the quickest of each group ties the clocks."""
    marks = sorted(e["ts"] + e.get("dur", 0) / 2 for e in events
                   if e.get("ph") == "X" and e.get("name") == ANCHOR
                   and e.get("cat") != "gpu_user_annotation")
    first, last = anchors
    if len(marks) != len(first) + len(last):
        raise RuntimeError(f"the profiler kept {len(marks)} of the "
                           f"{len(first) + len(last)} anchors: the spans "
                           f"cannot be placed on its clock")
    i = min(range(len(first)), key=lambda k: first[k][1])
    j = min(range(len(last)), key=lambda k: last[k][1])
    (a0, m0), (a1, m1) = (first[i][0], marks[i]), \
        (last[j][0], marks[len(first) + j])
    rate = (m1 - m0) / ((a1 - a0) * 1e6)
    pid, tid = os.getpid(), SPAN_TID
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "canny_edge_tpu_torch spans",
                     "dropped": dropped}}]
    for s in spans:
        out.append({"ph": "X", "cat": "canny_span", "name": s.name,
                    "pid": pid, "tid": tid,
                    "ts": m0 + (s.start - a0) * 1e6 * rate,
                    "dur": (s.end - s.start) * 1e6 * rate,
                    "args": {"request": s.request, "parent": s.parent}})
    return out
