"""Headline benchmark of the PyTorch/CUDA port: full-pipeline megapixels a
second a card at 1080p (the counterpart of ``bench.py``).

    python3 bench_torch.py

Prints ONE JSON line to standard output:
    {"metric": ..., "value": ..., "unit": "MP/s/card", "vs_baseline": ...,
     "best_backend": ..., "backends": {...}, "spread_pct": ...,
     "build_s": ..., "roofline": [...], "card": "<name>, <power limit>"}

It needs a card and has no CPU mode: without one it exits non-zero.

Baseline: 229 MP/s, the reference's tiled CUDA kernels on an RTX 2070
Max-Q, stages 1-3 only (BASELINE.md); the number here is the whole
pipeline, hysteresis included.

Protocol.  Each backend (``fused``, ``pallas``, ``xla``) runs the
functional entry point ``models.canny_fn`` on the card, sigma 1.4, 30/90:

* its time a frame is the slope of a chain of calls between two chain
  lengths (``utils.timing.checksum_slope_seconds``): every call perturbs
  its input, a checksum of every output stays on the card and is read once.
  The chain lengths are planned from a first timed call of the backend,
  since a fused frame is ~300x faster than an ``xla`` one;
* ``samples`` slopes a backend, the backends taken in turns within a
  sample, so that a drift of the host's speed reaches all of them alike;
  the value is the median, MP/s = pixels / median;
* beside the slope, which includes the host's enqueue and the checksum's
  own small launches, ``device_ms``: the time of the pipeline's kernels on
  the card by ``torch.profiler``;
* the roofline (``utils.roofline``): the front end alone is timed on the
  card (K1 with the thresholds for ``fused``, K1 to the NMS map for
  ``pallas``, the plain front end for ``xla``), hysteresis = full - front
  end.  Stage times are device times: a floor over the host's enqueue time
  would measure the host.  Each stage's compute floor is the audited
  ``alu`` count (``utils.opcount``) of its plain version at 1080p: the
  front end directly, the hysteresis by composition (one round of the plain
  packed flood, times the rounds it takes on this frame, plus its ends).
"""

import json
import subprocess
import sys
import time

import numpy as np

SIGMA, MN, MX = 1.4, 30, 90
HW = (1080, 1920)
BACKENDS = ("fused", "pallas", "xla")
BASELINE_MPS = 229.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_image(h, w, seed=0):
    """The headline frame: sinusoid, disc and noise (``bench.py``'s)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 96 + 64 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    img += 80 * (((xx - w / 2) ** 2 + (yy - h / 2) ** 2) < (min(h, w) / 3) ** 2)
    img += rng.normal(0, 6, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi gave nothing"


def audit_hysteresis(img, kernel, *, from_nm: bool, min_val=MN,
                     max_val=MX) -> dict:
    """Per-pixel operation buckets of the hysteresis stage, audited on its
    plain version (``ops/packed.py``) by composition:

        total = rounds * (one round: INNER_DILATE_XLA dilations, the row
                          and the column flood, the test)
                + ends (the words in and out, the unpack to int16; from an
                        NMS map also the two compares and the packing)

    ``rounds`` is what the plain flood takes on ``img``'s masks, so the
    data-dependent loop counts this frame's work, not the most it could.
    ``from_nm``: the stage starts from the NMS map (``pallas``, ``xla``),
    not from K1's packed masks (``fused``).  The test is ``torch.equal``,
    which has no tensor output and is not counted (one operation a word a
    round).
    """
    import torch

    from canny_edge_tpu_torch.ops import packed as P
    from canny_edge_tpu_torch.ops.window import frontend_nm
    from canny_edge_tpu_torch.utils.constants import INNER_DILATE_XLA
    from canny_edge_tpu_torch.utils.opcount import audit_compiled

    h, w = img.shape
    nm = frontend_nm(img, kernel)
    weak_p, strong_p = P.pack_mask(nm >= min_val), P.pack_mask(nm >= max_val)
    edges, rounds = P.hysteresis_packed_masks(weak_p, strong_p, h, w)
    weak = P.from_words(weak_p)

    def one_round(e):
        new = e
        for _ in range(INNER_DILATE_XLA):
            new = P.dilate_packed(new, weak)
        new = P.vflood(P.hflood(new, weak, w), weak, h)
        return torch.equal(new, e)

    def ends():
        if from_nm:
            P.pack_mask(nm >= min_val)
            P.pack_mask(nm >= max_val)
        P.from_words(weak_p)
        e = P.to_words(P.from_words(strong_p))
        return P.unpack_edges(edges, w), e

    per_round = audit_compiled(one_round, P.from_words(strong_p),
                               pixels=h * w)["buckets"]
    once = audit_compiled(ends, pixels=h * w)["buckets"]
    buckets = {k: round(rounds * per_round.get(k, 0.0) + once.get(k, 0.0), 2)
               for k in sorted(set(per_round) | set(once))}
    return {"buckets": buckets, "rounds": rounds,
            "inner_dilate": INNER_DILATE_XLA,
            "composition": "rounds*(dilations + row flood + column flood) "
                           "+ ends (words in and out, unpack to int16"
                           + (", compares and packing)" if from_nm else ")")}


def device_ms(fn, reps=5, windows=3, tries=8):
    """``(ms a call, {kernel: ms a call})`` of ``fn()`` on the card by
    ``torch.profiler``, or ``(None, {})`` when fewer than two of ``tries``
    windows recorded anything.

    Each window profiles ``reps`` calls, and ``windows`` windows that
    recorded something are merged, as ``chip_smoke.py`` phase 8 merges
    them: a window can lose a record, as a rule its first, so a kernel's
    launches a call are the most any window saw (its count over ``reps``,
    rounded) and its time a launch the mean over every launch recorded; a
    lost record changes neither, and a kernel one window lost is still
    counted.  (A profiler schedule's warm-up step lost whole windows of
    short calls on the H100.)  Kernels are keyed by their full names: many
    of PyTorch's share a long prefix."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call, count, total = {}, {}, {}
    seen = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        window = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
                n, t = window.get(e.key, (0, 0.0))
                window[e.key] = (n + e.count, t + us)
        if not window:
            continue
        for k, (n, us) in window.items():
            per_call[k] = max(per_call.get(k, 0), max(1, round(n / reps)))
            count[k] = count.get(k, 0) + n
            total[k] = total.get(k, 0.0) + us
        seen += 1
        if seen == windows:
            break
    if seen < 2:
        return None, {}
    by = {k: total[k] / count[k] * per_call[k] / 1e3 for k in per_call}
    return sum(by.values()), by


def _chain_lengths(fn, x):
    """``(k1, k2)`` for a slope of ``fn``: the long chain planned at
    ``CHAIN_TARGET_S`` from a first timed call (5 calls, synchronised), at
    least 10 and at most 4000 calls; the short one a twentieth, at least 2."""
    import torch

    from canny_edge_tpu_torch.utils.timing import CHAIN_TARGET_S

    fn(x, MN, MX)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        fn(x, MN, MX)
    torch.cuda.synchronize()
    est = (time.perf_counter() - t) / 5
    k2 = int(min(4000, max(10, CHAIN_TARGET_S / est)))
    return max(2, k2 // 20), k2


def measure(samples=5, hw=HW, sigma=SIGMA) -> dict:
    """The bench's record (see the module docstring), measured on the
    current CUDA device; ``RuntimeError`` without one."""
    import torch

    from canny_edge_tpu_torch.kernels import _build
    from canny_edge_tpu_torch.kernels import frontend as kfe
    from canny_edge_tpu_torch.models import canny_fn
    from canny_edge_tpu_torch.ops.gaussian import gaussian_kernel
    from canny_edge_tpu_torch.ops.window import frontend_nm
    from canny_edge_tpu_torch.utils.constants import geometry
    from canny_edge_tpu_torch.utils.opcount import audit_compiled
    from canny_edge_tpu_torch.utils.roofline import stage_rooflines
    from canny_edge_tpu_torch.utils.timing import checksum_slope_seconds

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch needs a CUDA device; it has no CPU "
                           "mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    h, w = hw
    kernel = gaussian_kernel(sigma)
    taps = torch.from_numpy(kernel).to(dev)
    img = torch.from_numpy(make_image(h, w)).to(dev)

    def full(b):
        def run(x, mn, mx):
            return canny_fn(x, mn, mx, kernel_vals=taps, hysteresis_steps=8,
                            backend=b)
        return run

    fronts = {   # the front end alone, as each backend runs it
        "fused": lambda x, mn, mx: kfe.frontend(x, taps, (mn, mx))[0].view(
            torch.int32),
        "pallas": lambda x, mn, mx: kfe.frontend(x, taps),
        "xla": lambda x, mn, mx: frontend_nm(x, kernel),
    }
    fns = {(b, s): (full(b) if s == "full" else fronts[b])
           for b in BACKENDS for s in ("full", "frontend")}
    chains = {key: _chain_lengths(fn, img) for key, fn in fns.items()}
    slopes = {key: [] for key in fns}
    for _ in range(samples):
        for key, fn in fns.items():
            k1, k2 = chains[key]
            slopes[key] += checksum_slope_seconds(
                fn, img, k1=k1, k2=k2, samples=1, return_samples=True,
                min_val=MN, max_val=MX)
    name = torch.cuda.get_device_name(dev)
    pixels = h * w
    backends, rooflines = {}, {}
    for b in BACKENDS:
        med = float(np.median(slopes[b, "full"]))
        full_dev, by = device_ms(lambda: fns[b, "full"](img, MN, MX))
        fe_dev, _ = device_ms(lambda: fns[b, "frontend"](img, MN, MX))
        backends[b] = {
            "ms_median": round(med * 1e3, 4),
            "samples_ms": [round(s * 1e3, 4) for s in slopes[b, "full"]],
            "mp_per_s": round(pixels / med / 1e6, 1),
            "device_ms": "not measured" if full_dev is None else full_dev,
            "device_by_kernel": {k[:64]: v for k, v in sorted(
                by.items(), key=lambda kv: -kv[1])[:8]},
            "device_kernels": len(by),
            "chain": list(chains[b, "full"]),
            "frontend_ms": round(float(np.median(
                slopes[b, "frontend"])) * 1e3, 4),
            "frontend_device_ms": ("not measured" if fe_dev is None
                                   else fe_dev),
        }
        audited = {
            "frontend": audit_compiled(
                lambda: frontend_nm(img, kernel, (MN, MX) if b == "fused"
                                    else None), pixels=pixels),
            "hysteresis": audit_hysteresis(img, kernel,
                                           from_nm=b != "fused")}
        rooflines[b] = [] if full_dev is None or fe_dev is None else \
            stage_rooflines(pixels, {"frontend": fe_dev / 1e3,
                                     "hysteresis": (full_dev - fe_dev) / 1e3},
                            name, backend=b, audited_ops=audited,
                            window=len(kernel))
        for r in rooflines[b]:
            r["audit_detail"] = {k: v for k, v in audited[r["stage"]].items()
                                 if k != "buckets"}
        log(f"[{b}] {med * 1e3:.4f} ms/frame ({pixels / med / 1e6:.0f} MP/s),"
            f" device {backends[b]['device_ms']} ms, "
            f"chain {chains[b, 'full']}")
    best = max(backends, key=lambda b: backends[b]["mp_per_s"])
    mps = backends[best]["mp_per_s"]
    s = backends[best]["samples_ms"]
    return {
        "metric": f"full-pipeline {h}p megapixels/sec/card (sigma={sigma}, "
                  f"best backend, median of {samples})",
        "value": mps,
        "unit": "MP/s/card",
        "vs_baseline": round(mps / BASELINE_MPS, 2),
        "baseline": f"{BASELINE_MPS} MP/s: the reference's tiled CUDA "
                    "kernels, stages 1-3, on an RTX 2070 Max-Q (BASELINE.md)",
        "best_backend": best,
        "backends": backends,
        "spread_pct": round(100.0 * (max(s) - min(s))
                            / backends[best]["ms_median"], 1),
        "build_s": round(build_s, 2),
        "roofline": rooflines[best],
        "roofline_by_backend": rooflines,
        "card": card(),
        "device": name,
        "geometry": geometry(dev),
        "torch": f"{torch.__version__} cuda {torch.version.cuda}",
    }


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch.py: no CUDA device; the bench measures the "
                 "card and has no CPU mode")
    print(json.dumps(measure()), flush=True)


if __name__ == "__main__":
    main()
