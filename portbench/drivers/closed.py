"""A closed loop: one caller hands the program a request, a frame or a
batch from a pool on the card, and has at most ``depth`` of them in
flight: after handing in request k it waits for request k - depth + 1.

Traffic parameters (``portbench/traffic/<mix>.json``):

* ``entry``: ``"call"`` (``CannyTorch.__call__`` on an ``(H, W)`` view of
  the pool) or ``"batch"`` (``CannyTorch.batch`` on ``batch`` consecutive
  frames of the pool, a ``(batch, H, W)`` view);
* ``batch``, ``depth``;
* ``pool_bytes``: the pool holds at least this many bytes of frames (a
  whole number of requests; a frame's bytes are its pixels times its type's
  size, ``harness/spec.py:frame_itemsize``), made on the card from the seed;
  requests take its inputs round-robin;
* ``sample_pixels``: enough requests to hold that many pixels (at least
  one) have their outputs judged;
* ``trace_after_s``, ``trace_requests``, ``trace_max_s``: the traced slice
  of a ``--trace 1`` run starts that long into the window and spans that
  many requests, or that many seconds, whichever ends first; it starts and
  ends with nothing in flight.

A request's latency runs from its call's start to the moment its
completion is observed (a CUDA event's ``synchronize``).
"""

from __future__ import annotations

import math
import time
from collections import deque

from portbench.harness.check import Reservoir
from portbench.harness.device import Waits
from portbench.harness.spec import frame_itemsize, frame_type
from portbench.reference import frames


def plan(config: dict, traffic: dict, seed: int) -> dict:
    """The traffic drawn from ``seed``, on the host: the pool's frames."""
    h, w, b = config["height"], config["width"], traffic["batch"]
    frame_bytes = h * w * frame_itemsize(config)
    n = b * math.ceil(math.ceil(traffic["pool_bytes"] / frame_bytes) / b)
    return {"seed": seed, "params": frames.frame_params(n, h, w, seed),
            "pool_frames": n, "pool_bytes": n * frame_bytes}


class Workload:
    def __init__(self, config: dict, traffic: dict, plan: dict, device,
                 model):
        h, w = config["height"], config["width"]
        self.batch = b = traffic["batch"]
        self.depth = traffic["depth"]
        self.traffic = traffic
        self.pool = frames.make_pool(plan["params"], h, w, plan["seed"],
                                     device, config["scene_width"],
                                     *frame_type(config))
        n = self.pool.shape[0]
        self.single = traffic["entry"] == "call"
        if self.single and b == 1:
            self.inputs = [self.pool[i] for i in range(n)]
            entry = model.__call__
        elif traffic["entry"] == "batch":
            self.inputs = [self.pool[i:i + b] for i in range(0, n, b)]
            entry = model.batch
        else:
            raise ValueError(f"entry {traffic['entry']!r} with batch {b}")
        lo, hi = config["min_val"], config["max_val"]
        self.call = lambda x: entry(x, lo, hi)
        self.waits = Waits(device, self.depth + 1)
        k = max(1, traffic["sample_pixels"] // (b * h * w))
        self.sampler = Reservoir(k, plan["seed"])
        self.expected = None          # frames to judge, once the run is over

    def warm(self) -> None:
        """Every input of the pool once, ``depth`` in flight."""
        for i, x in enumerate(self.inputs):
            self.call(x)
            if (i + 1) % self.depth == 0:
                self.waits.sync()
        self.waits.sync()

    def run(self, seconds: float, tracer) -> dict:
        inputs, call, waits = self.inputs, self.call, self.waits
        n_in, depth, tr = len(inputs), self.depth, self.traffic
        starts, call_ends, dones = [], [], []
        inflight = deque()
        offer = self.sampler.offer
        now = time.perf_counter

        def finish_one():
            j, out, ev = inflight.popleft()
            tw = now()
            t = waits.wait(ev)
            dones.append(t)
            tracer.span("wait", tw, t)
            offer(j, out)

        slice_a = slice_b = slice_t = None
        t0 = now()
        deadline = t0 + seconds
        i = 0
        while True:
            tn = now()
            if tn >= deadline:
                break
            if tracer.enabled and not tracer.done:
                if not tracer.active and tn - t0 >= tracer.after_s:
                    while inflight:
                        finish_one()
                    tracer.start()
                    slice_a, slice_t = i, now()
                elif tracer.active and (i - slice_a >= tr["trace_requests"]
                                        or tn - slice_t >= tr["trace_max_s"]):
                    while inflight:
                        finish_one()
                    tracer.stop()
                    slice_b = i
            x = inputs[i % n_in]
            ts = now()
            out = call(x)
            te = now()
            ev = waits.mark(i)
            starts.append(ts)
            call_ends.append(te)
            tracer.span("next", tn, ts)
            tracer.span("call", ts, te)
            inflight.append((i, out, ev))
            if len(inflight) >= depth:
                finish_one()
            i += 1
        while inflight:
            finish_one()
        if tracer.active:
            tracer.stop()
            slice_b = i
        self.expected = min(self.sampler.k, len(dones)) * self.batch
        traced = None if slice_a is None else (slice_a, slice_b)
        return {"window": (t0, dones[-1]), "starts": starts,
                "call_ends": call_ends, "dones": dones,
                "frames_per_request": self.batch, "attempted": i,
                "traced": traced}

    def tasks(self) -> list:
        """``(frame, [outputs])`` for every pool frame a sampled request
        read, on the host; the card's state is released."""
        b, n_in = self.batch, len(self.inputs)
        outs: dict[int, list] = {}
        for j, out in self.sampler.items:
            first = (j % n_in) * b
            host = out.cpu().numpy()
            for f in range(b):
                outs.setdefault(first + f, []).append(
                    host if self.single else host[f])
        pool = self.pool
        tasks = [(pool[k].cpu().numpy(), v) for k, v in sorted(outs.items())]
        self.pool = self.inputs = self.sampler = self.call = None
        return tasks
