"""Per-stage timing and throughput (``canny_edge_tpu/utils/timing.py``).

On the card every interval is timed with CUDA events around a chain of
calls queued back to back; on the CPU with ``perf_counter``, the work being
done when the call returns.  :func:`profile_stages` keeps the JAX package's
meaning: each stage is the marginal cost of appending it to the pipeline
prefix (blur / +sobel / +nms / +hysteresis), each prefix timed by
:func:`checksum_slope_seconds`, the slope between two chain lengths, which
cancels the fixed cost of a chain.  Blur, Sobel and NMS are the stage ops of
:mod:`..ops.stages`; the hysteresis is K2 from the NMS map
(:func:`..kernels.hysteresis_packed.hysteresis_packed_nm`), as JAX times its
packed flood there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.fused import resolve_device, to_device
from ..kernels.hysteresis_packed import hysteresis_packed_nm
from ..ops import stages as S
from ..ops.gaussian import gaussian_kernel

# Seconds a pixel of the full stage prefix (blur, Sobel and NMS in plain
# PyTorch, then K2) takes on the card: 3.60 ms a 1080p frame, 1.7e-9 s/px,
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, report
# "cli_path"/"times"/"stage_path_s_per_px"), bound by the host queueing
# over a hundred small operations.  It plans chain lengths only; no result
# reads it.
PLANNING_S_PER_PX = 1.7e-9
# seconds the long chain of a slope is planned to take
CHAIN_TARGET_S = 0.25
# slopes of each prefix whose median :func:`profile_stages` reports
SLOPE_SAMPLES = 5


@dataclass
class StageStats:
    name: str
    ms: float
    mps: float  # megapixels/sec


@dataclass
class PipelineReport:
    image_shape: tuple
    stages: list[StageStats] = field(default_factory=list)
    total_ms: float = 0.0
    total_mps: float = 0.0
    protocol: str = "slope"
    prefix_ms: list[float] = field(default_factory=list)

    def table(self) -> str:
        lines = [f"{'stage':<12}{'ms':>10}{'MP/s':>12}   [{self.protocol}]"]
        for s in self.stages:
            lines.append(f"{s.name:<12}{s.ms:>10.3f}{s.mps:>12.0f}")
        lines.append(f"{'TOTAL':<12}{self.total_ms:>10.3f}{self.total_mps:>12.0f}")
        return "\n".join(lines)

    def json(self) -> dict:
        return {
            "image_shape": list(self.image_shape),
            "stages": [vars(s) for s in self.stages],
            "total_ms": self.total_ms,
            "total_mps": self.total_mps,
            "protocol": self.protocol,
            "prefix_ms": self.prefix_ms,
        }


class _Clock:
    """Seconds of the work queued between :meth:`start` and :meth:`stop`:
    CUDA events on the card, ``perf_counter`` on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return time.perf_counter() - self._t
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        b.synchronize()
        return self._a.elapsed_time(b) / 1e3


def _time_call(fn, *args, device, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds a call, after ``warmup`` calls."""
    clock = _Clock(device)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        clock.start()
        fn(*args)
        ts.append(clock.stop())
    return float(np.median(ts))


def profile_stages(img: np.ndarray, sigma: float, min_val: int, max_val: int,
                   iters: int = 10, protocol: str = "slope",
                   device="cuda") -> PipelineReport:
    """Per-stage times of the stage path on ``device`` (the card by default;
    ``RuntimeError`` without one; ``"cpu"``).

    ``protocol="slope"`` (default): each stage is the marginal cost of
    appending it to the prefix (blur / +sobel / +nms / +hysteresis), each
    prefix the median of :data:`SLOPE_SAMPLES` slopes as in
    :func:`checksum_slope_seconds`, the four prefixes taken in turn within a
    sample (on the card the stage ops are as fast as the host queues them,
    and the host's speed drifts); chain lengths from
    :func:`auto_chain_lengths` on the card, from one timed call on the CPU.
    ``protocol="wall"``: each stage called on its own inputs, median of
    ``iters`` calls.
    """
    dev = resolve_device(device)
    kernel = gaussian_kernel(sigma)
    x = to_device(img, dev)
    mp = img.shape[-2] * img.shape[-1] / 1e6

    def blur(t):
        return S._gaussian_blur_with_kernel(t, kernel)

    def p_blur(t, a, b):
        return blur(t)

    def p_sobel(t, a, b):
        mag, ang = S.sobel(blur(t))
        return mag + ang               # keep the angle live

    def p_nms(t, a, b):
        return S.nonmax_suppression(*S.sobel(blur(t)))

    def p_full(t, a, b):
        return hysteresis_packed_nm(p_nms(t, a, b), a, b)

    if protocol == "slope":
        if dev.type == "cpu":
            p_full(x, min_val, max_val)
            t0 = time.perf_counter()
            p_full(x, min_val, max_val)
            est = max(time.perf_counter() - t0, 1e-5)
            k2 = int(min(4000, max(20, 0.5 / est)))
            k1 = max(2, k2 // 20)
        else:
            k1, k2 = auto_chain_lengths(int(np.prod(img.shape)))
        prefix_sec = [float(np.median(sl)) for sl in _slope_samples(
            (p_blur, p_sobel, p_nms, p_full), x, k1, k2, SLOPE_SAMPLES,
            min_val, max_val)]
        report = PipelineReport(image_shape=tuple(img.shape),
                                protocol="slope",
                                prefix_ms=[round(s * 1e3, 4)
                                           for s in prefix_sec])
        prev = 0.0
        for name, sec in zip(("gaussian", "sobel", "nms", "hysteresis"),
                             prefix_sec):
            marg = max(sec - prev, 1e-9)
            report.stages.append(StageStats(name, marg * 1e3, mp / marg))
            prev = sec
        report.total_ms = prefix_sec[-1] * 1e3
        report.total_mps = mp / prefix_sec[-1]
        return report
    if protocol != "wall":
        raise ValueError(f"unknown protocol {protocol!r}")
    sm = blur(x)
    mag, ang = S.sobel(sm)
    nm = S.nonmax_suppression(mag, ang)
    report = PipelineReport(image_shape=tuple(img.shape), protocol="wall")
    for name, fn, args in [
            ("gaussian", blur, (x,)),
            ("sobel", S.sobel, (sm,)),
            ("nms", S.nonmax_suppression, (mag, ang)),
            ("hysteresis", hysteresis_packed_nm, (nm, min_val, max_val))]:
        sec = _time_call(fn, *args, device=dev, iters=iters)
        report.stages.append(StageStats(name, sec * 1e3, mp / sec))
    report.total_ms = sum(s.ms for s in report.stages)
    report.total_mps = mp / (report.total_ms / 1e3)
    return report


def auto_chain_lengths(pixels: int) -> tuple[int, int]:
    """Chain lengths ``(k1, k2)`` for a slope on the card: the long chain
    planned at :data:`CHAIN_TARGET_S` from :data:`PLANNING_S_PER_PX`, at
    least 40 and at most 4000 calls; the short one a twentieth of it."""
    per_iter = max(pixels, 1) * PLANNING_S_PER_PX
    k2 = int(min(4000, max(40, CHAIN_TARGET_S / per_iter)))
    return max(4, k2 // 20), k2


def _slope_samples(fns, x: torch.Tensor, k1: int, k2: int, samples: int,
                   min_val: int, max_val: int) -> list:
    """``samples`` slopes of each function in ``fns`` (seconds a call),
    the functions taken in turn within each sample, so that a drift of the
    host's speed reaches all of them alike.  See
    :func:`checksum_slope_seconds`."""
    inputs = [x ^ j for j in range(5)]
    clock = _Clock(x.device)

    def run(fn, seed: int, k: int) -> tuple[float, int]:
        chk = torch.full((), seed, dtype=torch.int64, device=x.device)
        clock.start()
        for i in range(k):
            out = fn(inputs[(seed + i) % 5], min_val + (seed + i) % 3,
                     max_val)
            chk = (chk * 16777619 + out[..., ::97, ::89].sum()) & 0x7FFFFFFF
        sec = clock.stop()
        return sec, int(chk)

    for fn in fns:
        run(fn, 1, k1)
        run(fn, 1, k2)
    slopes = [[] for _ in fns]
    for s in range(2, 2 + samples):
        for fn, out in zip(fns, slopes):
            t1, c1 = run(fn, s, k1)
            t2, c2 = run(fn, s, k2)
            if c1 == c2:
                raise RuntimeError("the two chains gave one checksum")
            out.append(max((t2 - t1) / (k2 - k1), 1e-9))
    return slopes


def checksum_slope_seconds(pipe_fn, img, *, k1: int | None = None,
                           k2: int | None = None, samples: int = 3,
                           min_val: int = 30, max_val: int = 90,
                           return_samples: bool = False, device="cuda"):
    """Seconds a call of ``pipe_fn(img, mn, mx)`` takes in a chain: the
    slope of the chain's time between ``k1`` and ``k2`` calls, the median
    of ``samples``.

    Call i of a chain takes one of five inputs (``img ^ j``) and the minimum
    threshold ``min_val + i % 3``, so calls differ; a checksum of every
    output, kept on the device, is read once at the end (its value differs
    between the two chain lengths).  ``img``: a tensor, timed where it lies,
    or an array moved to ``device``.  Defaults of ``k1``/``k2`` come from
    :func:`auto_chain_lengths`.
    """
    x = to_device(img, device)
    if k1 is None or k2 is None:
        a1, a2 = auto_chain_lengths(int(np.prod(x.shape)))
        k1 = a1 if k1 is None else k1
        k2 = a2 if k2 is None else k2
    slopes = _slope_samples([pipe_fn], x, k1, k2, samples, min_val,
                            max_val)[0]
    return slopes if return_samples else float(np.median(slopes))


def throughput_chained(pipe_fn, img, k: int = 20, repeats: int = 3,
                       device="cuda") -> float:
    """Frames a second of ``k`` calls queued back to back (the best of
    ``repeats`` chains), the thresholds alternating 50/51 and 150."""
    x = to_device(img, device)
    clock = _Clock(x.device)

    def run_k():
        acc = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(k):
            acc = acc + pipe_fn(x, 50 + i % 2, 150).reshape(-1)[0]
        return acc

    run_k()
    best = np.inf
    for _ in range(repeats):
        clock.start()
        run_k()
        best = min(best, clock.stop() / k)
    return 1.0 / best
