"""The port's span recorder (``canny_edge_tpu_torch/utils/trace.py``), the
spans of the entry point, the K1/K2 wrappers and the launch plan, and K2's
count of flood steps: on the CPU the plain versions, on the card (``cuda``
marker) the kernels, a request through its launch plan."""

import json
import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

from canny_edge_tpu_torch import CannyTorch
from canny_edge_tpu_torch.io.imageio import synthetic_image
from canny_edge_tpu_torch.kernels import hysteresis_packed as khp
from canny_edge_tpu_torch.models.canny import canny_fn, canny_fn_packed
from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
from canny_edge_tpu_torch.utils import trace
from tools.entry_spans import per_request, split_call

STAGES = ["entry.check", "k1.prep", "k1.launch", "k2.prep", "k2.launch"]
# a request on the card that takes its launch plan (kernels/plan.py)
PLAN_STAGES = ["entry.check", "plan.prep", "plan.launch"]
SIGMA, MN, MX = 1.4, 30, 90


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.fixture
def recorder():
    """Recording on for the test, off and drained after it."""
    trace.start_recording()
    try:
        yield trace
    finally:
        trace.stop_recording()
        trace.drain()


def _frames(n=2, h=24, w=40):
    return np.stack([synthetic_image(h, w, seed=s) for s in range(n)])


def _request(kind, frames, device="cpu"):
    """One request of ``kind`` on ``frames`` (two frames; one where the
    entry point takes a frame)."""
    model = CannyTorch(SIGMA, device=device)
    taps = model.taps
    img = torch.from_numpy(frames[0]).to(device)
    batch = torch.from_numpy(frames).to(device)
    if kind == "__call__":
        return model(frames[0], MN, MX)
    if kind == "pallas":
        return CannyTorch(SIGMA, device=device, backend="pallas")(img, MN, MX)
    if kind == "packed":
        return model.packed(img, MN, MX)
    if kind == "batch":
        return model.batch(batch, MN, MX)
    if kind == "batch_packed":
        return model.batch_packed(batch, MN, MX)
    if kind == "canny_fn":
        return canny_fn(img, MN, MX, kernel_vals=taps, backend="fused")
    if kind == "canny_fn_batch":
        return canny_fn(batch, MN, MX, kernel_vals=taps, backend="fused")
    assert kind == "canny_fn_packed"
    return canny_fn_packed(batch, MN, MX, kernel_vals=taps)


KINDS = ["__call__", "pallas", "packed", "batch", "batch_packed", "canny_fn",
         "canny_fn_batch", "canny_fn_packed"]


def _requests(spans):
    """``{request: (root index, [child names in order])}``, with each
    child's parent, request and interval checked against its root."""
    out = {}
    for i, s in enumerate(spans):
        if s.parent == -1:
            assert s.name == "entry" and s.request not in out
            out[s.request] = (i, [])
    for s in spans:
        if s.parent == -1:
            continue
        root, names = out[s.request]
        assert s.parent == root, s
        r = spans[root]
        assert r.start <= s.start <= s.end <= r.end, (r, s)
        names.append(s.name)
    return out


def test_off_records_nothing():
    trace.start_recording()
    trace.stop_recording()
    _request("__call__", _frames())
    assert trace.drain() == ([], 0)


@pytest.mark.parametrize("kind", KINDS)
def test_each_request_is_one_entry_with_its_stages(kind, recorder):
    frames = _frames()
    for _ in range(2):
        _request(kind, frames)
    spans, dropped = recorder.drain()
    assert dropped == 0
    reqs = _requests(spans)
    assert len(reqs) == 2
    for root, names in reqs.values():
        assert names == STAGES, names
        kids = [s for s in spans if s.parent == root]
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("kind", KINDS)
def test_recording_changes_no_edge(kind):
    frames = _frames(h=40, w=70)
    off = _request(kind, frames)
    trace.start_recording()
    try:
        on = _request(kind, frames)
    finally:
        trace.stop_recording()
        trace.drain()
    assert torch.equal(off, on)


def test_buffer_bound_counts_what_it_drops():
    trace.start_recording(capacity=5)
    try:
        for _ in range(2):
            _request("__call__", _frames())
    finally:
        trace.stop_recording()
    spans, dropped = trace.drain()
    # a span is kept as it closes: the first request's stages fit, not its
    # root, which closes after them
    assert [(s.name, s.parent) for s in spans] == [(n, -1) for n in STAGES]
    assert dropped == 2 * (1 + len(STAGES)) - 5
    assert trace.drain() == ([], 0)


def test_an_exception_closes_the_request(recorder):
    model = CannyTorch(SIGMA, device="cpu")
    with pytest.raises(ValueError, match="minVal must be less"):
        model(_frames()[0], 90, 30)
    _request("__call__", _frames())
    spans, _ = recorder.drain()
    reqs = _requests(spans)
    # the check that raised is cut short and not recorded
    assert [names for _, names in reqs.values()] == [[], STAGES]


def test_annotate_records_a_span(recorder):
    with trace.annotate("frame"):
        _request("__call__", _frames())
    spans, _ = recorder.drain()
    assert [(s.name, s.parent) for s in spans[:2]] == [("frame", -1),
                                                       ("entry", 0)]
    assert {s.request for s in spans} == {spans[0].request}
    assert spans[0].start <= spans[1].start <= spans[1].end <= spans[0].end


def test_threads_nest_their_own_spans():
    """Threads recording at once: every request keeps its own root and
    stages (a shortened switch interval interleaves them)."""
    frames = _frames(n=1, h=16, w=24)
    errors = []

    def work():
        try:
            for _ in range(10):
                _request("__call__", frames)
        except Exception as e:      # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.start_recording()
    try:
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        trace.stop_recording()
        sys.setswitchinterval(old)
    spans, dropped = trace.drain()
    assert errors == [] and dropped == 0
    reqs = _requests(spans)
    assert len(reqs) == 10 * len(threads)
    assert all(names == STAGES for _, names in reqs.values())


def test_trace_writes_the_spans_beside_the_operators(tmp_path):
    model = CannyTorch(SIGMA, device="cpu")
    frame = _frames(h=64, w=96)[0]
    with trace.trace(str(tmp_path), device="cpu") as out:
        model(frame, MN, MX)
    assert not trace.RECORDING
    events = json.load(open(os.path.join(out, "trace.json")))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "canny_span"}
    assert set(spans) == {"entry", *STAGES}
    assert spans["entry"]["args"]["parent"] == -1
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    # the plain front end's operators lie inside k1.launch on the
    # profiler's clock, and none of them before the request
    run = spans["k1.launch"]
    inside = [e for e in ops if run["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= run["ts"] + run["dur"]]
    assert inside
    first = min(e["ts"] for e in ops if e["name"].startswith("aten::"))
    assert first >= spans["entry"]["ts"]


def test_trace_keeps_a_recording_the_caller_started(tmp_path, recorder):
    """Inside a recording, ``trace()`` copies its block's spans into its
    file and leaves the recording on, with every span still to drain."""
    model = CannyTorch(SIGMA, device="cpu")
    frame = _frames(h=32, w=48)[0]
    model(frame, MN, MX)
    with trace.trace(str(tmp_path), device="cpu"):
        model(frame, MN, MX)
    assert trace.RECORDING
    model(frame, MN, MX)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "canny_span"]
    assert sorted(names) == sorted(["entry", *STAGES])
    spans, dropped = recorder.drain()
    assert dropped == 0 and len(_requests(spans)) == 3


def test_trace_without_its_anchors_writes_no_spans(tmp_path, monkeypatch):
    """Where the profiler loses an anchor region, the file is the
    profiler's own, with a warning, and the recording ends all the same."""
    real = trace.span_events

    def lose_one(spans, anchors, events, dropped=0):
        k = next(i for i, e in enumerate(events)
                 if e.get("name") == trace.ANCHOR)
        return real(spans, anchors, events[:k] + events[k + 1:], dropped)

    monkeypatch.setattr(trace, "span_events", lose_one)
    with pytest.warns(UserWarning, match="holds no spans"):
        with trace.trace(str(tmp_path), device="cpu"):
            CannyTorch(SIGMA, device="cpu")(_frames(h=32, w=48)[0], MN, MX)
    assert not trace.RECORDING and trace.drain() == ([], 0)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert events and not any(e.get("cat") == "canny_span" for e in events)


def _span(name, start, end, parent=-1, request=0):
    return trace.Span(name, start, end, parent, request)


def test_per_request_parts_the_launches_from_the_rest():
    ms = 1e-3
    spans = [_span("entry", 0, 10 * ms, request=0),
             _span("entry.check", 0, 1 * ms, 0),
             _span("k1.prep", 1 * ms, 4 * ms, 0),
             _span("k1.launch", 4 * ms, 5 * ms, 0),
             _span("k2.launch", 6 * ms, 9 * ms, 0),
             _span("entry", 20 * ms, 26 * ms, request=1),
             _span("k1.launch", 21 * ms, 23 * ms, 5, 1),
             _span("frame", 30 * ms, 31 * ms, request=2)]
    got = per_request(spans)
    assert got["requests"] == 2
    assert got["entry_launch_ms"] == pytest.approx((4 + 2) / 2)
    assert got["entry_prep_ms"] == pytest.approx((6 + 4) / 2)
    assert got["per_request_ms"] == pytest.approx(
        {"entry": 8, "entry.check": 0.5, "k1.prep": 1.5, "k1.launch": 1.5,
         "k2.launch": 1.5})
    assert per_request([])["requests"] == 0


def test_per_request_counts_the_plan_launch_as_launch_time():
    """A request through its launch plan: ``plan.launch`` (K1 and K2 in
    one C call) is launch time, ``plan.prep`` the rest of the entry."""
    ms = 1e-3
    spans = [_span("entry", 0, 8 * ms, request=0),
             _span("entry.check", 0, 1 * ms, 0),
             _span("plan.prep", 1 * ms, 3 * ms, 0),
             _span("plan.launch", 3 * ms, 7 * ms, 0)]
    got = per_request(spans)
    assert got["requests"] == 1
    assert got["entry_launch_ms"] == pytest.approx(4)
    assert got["entry_prep_ms"] == pytest.approx(4)
    assert got["per_request_ms"] == pytest.approx(
        {"entry": 8, "entry.check": 1, "plan.prep": 2, "plan.launch": 4})


def test_split_call_by_the_innermost_span():
    spans = [_span("entry", 1, 9), _span("k1.prep", 2, 4, 0),
             _span("k1.launch", 4, 5, 0), _span("k2.prep", 6, 8, 0)]
    got = split_call([(0, 3), (4.5, 7), (8.5, 12)], [(0.5, 10)], spans)
    # idle inside the call: 0.5-3, 4.5-7 and 8.5-10
    assert got == pytest.approx({"call": 0.5 + 1, "call/entry": 1 + 1 + 0.5,
                                 "call/k1.prep": 1, "call/k1.launch": 0.5,
                                 "call/k2.prep": 1})


@pytest.mark.parametrize("seed", range(4))
def test_split_call_adds_up_to_the_idle_time_in_calls(seed):
    """The ``call/<span>`` entries and ``call`` sum to the idle time that
    lies inside the calls, whatever the spans."""
    rng = random.Random(seed)
    calls, spans, t = [], [], 0.0
    for _ in range(40):
        a = t + rng.uniform(0.1, 1)
        b = a + rng.uniform(1, 5)
        calls.append((a, b))
        root = len(spans)
        spans.append(_span("entry", a + rng.uniform(0, 0.2),
                           b - rng.uniform(0, 0.2)))
        u = spans[root].start
        for name in STAGES:
            v = min(u + rng.uniform(0, 1), spans[root].end)
            spans.append(_span(name, u, v, root))
            u = v
        t = b
    points = sorted(rng.uniform(0, t + 1) for _ in range(60))
    gaps = list(zip(points[::2], points[1::2]))
    whole = sum(max(0.0, min(b, y) - max(a, x))
                for a, b in gaps for x, y in calls)
    got = split_call(gaps, calls, spans)
    assert sum(got.values()) == pytest.approx(whole)
    assert set(got) <= {"call", "call/entry", *("call/" + n for n in STAGES)}


def test_cpu_steps_are_the_plain_rounds():
    from canny_edge_tpu_torch.kernels.frontend import frontend

    frames = _frames(n=3, h=40, w=70)
    taps = torch.from_numpy(gaussian_kernel(SIGMA))
    masks = [frontend(torch.from_numpy(f), taps, (MN, MX)) for f in frames]
    rounds = [khp.hysteresis_packed(w, s, 40, 70, return_steps=True)[1]
              for w, s in masks]
    before = khp.flood_steps()
    for w, s in masks:
        khp.hysteresis_packed(w, s, 40, 70)
    khp.hysteresis_packed(torch.stack([w for w, _ in masks]),
                          torch.stack([s for _, s in masks]), 40, 70)
    # a call counts the most any of its frames needed, as a launch does
    assert khp.flood_steps() - before == sum(rounds) + max(rounds)


@pytest.mark.cuda
def test_card_steps_equal_return_steps(cuda_device):
    """The card's running count adds each launch's steps, on both K2
    entries, and the edges are the plain version's bit for bit."""
    from canny_edge_tpu_torch.kernels.frontend import frontend

    frames = [synthetic_image(270, 480, seed=s) for s in range(4)]
    taps = torch.from_numpy(gaussian_kernel(SIGMA))
    cases = []
    for f in frames:       # the plain version's rounds count too: first
        img = torch.from_numpy(f)
        nm_cpu = frontend(img, taps)
        cases.append((nm_cpu, *frontend(img, taps, (MN, MX)),
                      khp.hysteresis_packed_nm(nm_cpu, MN, MX)))
    steps, n = 0, 0
    before, launches = khp.flood_steps(), khp.launches
    for nm_cpu, weak, strong, want in cases:
        for out, k in (
                khp.hysteresis_packed_nm(nm_cpu.to(cuda_device), MN, MX,
                                         return_steps=True),
                khp.hysteresis_packed(weak.to(cuda_device),
                                      strong.to(cuda_device), 270, 480,
                                      edges_int16=True, return_steps=True)):
            assert torch.equal(out.cpu(), want)
            steps, n = steps + int(k), n + 1
    assert khp.launches - launches == n
    assert khp.flood_steps() - before == steps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["__call__", "batch", "packed"])
def test_card_spans_and_edges(kind, cuda_device):
    frames = _frames(h=270, w=480)
    off = _request(kind, frames, cuda_device)
    trace.start_recording()
    try:
        on = _request(kind, frames, cuda_device)
    finally:
        trace.stop_recording()
    spans, dropped = trace.drain()
    assert torch.equal(off, on) and dropped == 0
    assert [names for _, names in _requests(spans).values()] == [PLAN_STAGES]
    cpu = _request(kind, frames)
    assert torch.equal(on.cpu(), cpu)


@pytest.mark.cuda
def test_card_trace_places_launches_inside_their_spans(cuda_device,
                                                       tmp_path):
    """In ``trace()``'s file, the runtime's launch of each kernel lies
    inside the launch span of its request's plan, ``plan.launch`` (K1 and
    K2 in one C call): the spans share the profiler's clock.  (The
    profiler may lose a few records, most often in its first capture,
    which is a throwaway here.)"""
    model = CannyTorch(SIGMA)
    frames = torch.from_numpy(_frames(n=4, h=270, w=480)).to(cuda_device)
    with trace.trace(str(tmp_path / "warm")):
        model(frames[0], MN, MX)
        torch.cuda.synchronize()
    with trace.trace(str(tmp_path)):
        for i in range(200):
            model(frames[i % 4], MN, MX)
        torch.cuda.synchronize()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel"}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "canny_span" and e["name"] == "plan.launch"]
    assert len(spans) >= 180
    n, inside = {"k1": 0, "k2": 0}, {"k1": 0, "k2": 0}
    for e in events:
        if e.get("cat") != "cuda_runtime" or \
                not e["name"].startswith("cudaLaunch"):
            continue
        kname = kernels.get(e["args"].get("correlation"), "")
        name = ("k2" if "flood_kernel" in kname else
                "k1" if "frontend" in kname else None)
        if name is None:
            continue
        n[name] += 1
        inside[name] += any(s <= e["ts"] and e["ts"] + e["dur"] <= t
                            for s, t in spans)
    for k in n:
        assert n[k] >= 180 and inside[k] >= 0.99 * n[k], (inside, n)
