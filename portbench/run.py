#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell names a configuration (``portbench/configs/``) and a traffic mix
(``portbench/traffic/<mix>.json``), whose driver
(``portbench/drivers/<driver>.py``) makes the pool from the seed, warms up
the cell's shapes and runs the measured window; each metric is read by
``portbench/metrics/<name>.py``.  With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled slice of the window.  Once the window has closed, sampled
outputs are compared with the frozen NumPy oracle (``correct``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error).  Without a card, or with fewer
than the cell asks for, it exits 2 and prints no result; where JAX or the
JAX package is loaded after the window, it exits 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0
    return age if 0.0 <= age < 60.0 else 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(name: str, seed: int, trace: bool):
    """The cell, its driver, the traffic drawn from ``seed`` and the metric
    readers the run reports: everything found by name, nothing on the
    card."""
    from portbench.harness import spec

    cell = spec.resolve(name)
    driver = spec.load_driver(cell)
    plan = driver.plan(cell.config, cell.traffic, seed)
    readers = [(m, spec.load_metric(m["name"])) for m in cell.metrics(trace)]
    return cell, driver, plan, readers


def pin_caches() -> None:
    """Every kernel cache at a fixed path inside the checkout.  (The
    program's own libraries go to ``canny_edge_tpu_torch/kernels/build``.)"""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)


def measure(cell, driver, plan, readers, *, seconds: float, trace: bool,
            device, make_model, t_start: float, wrap=None) -> dict:
    """Set up, run the window, judge, read the metrics: the result line.
    ``wrap(model)`` (tests) puts a fault under the timed path."""
    import numpy as np
    import torch

    from portbench.harness import device as cores
    from portbench.harness.check import judge_samples, passed
    from portbench.harness.imports import foreign
    from portbench.harness.record import Run
    from portbench.harness.trace import Tracer, breakdown

    cuda = device.type == "cuda"
    phases = {"start": time.perf_counter() - t_start}
    model = make_model(cell.config, device)
    if wrap is not None:
        model = wrap(model)
    phases["model"] = time.perf_counter() - t_start
    work = driver.Workload(cell.config, cell.traffic, plan, device, model)
    phases["pool"] = time.perf_counter() - t_start
    work.warm()
    phases["warm"] = time.perf_counter() - t_start
    tracer = Tracer(trace, cuda)
    tracer.after_s = min(cell.traffic["trace_after_s"], seconds / 4)
    if trace:
        tracer.warm()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # set-up's objects out of the collector's way: a full collection in the
    # window would scan every one of them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    mhz = [cores.cpu_mhz()]
    cores.pin("main")
    rec = work.run(seconds, tracer)
    cores.pin("rest")
    mhz.append(cores.cpu_mhz())
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = foreign(sys.modules)
    if found:
        log(f"portbench: loaded after the window: {', '.join(found)}")
        raise SystemExit(3)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    traced = rec["traced"]
    n_traced = 0 if traced is None else traced[1] - traced[0]
    run = Run(config=cell.config, setup_s=setup_s,
              pixels_per_frame=cell.config["height"] * cell.config["width"],
              failed=rec["attempted"] - len(rec["dones"]), device_kind=kind,
              **rec)
    run.trace = tracer.collect(n_traced)
    tasks, expected = work.tasks(), work.expected
    del model, work
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = judge_samples(tasks, cell.config, expected)
    check_s = time.perf_counter() - t
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": passed(checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    lat = run.latencies_s()
    result["info"] = {
        "requests": run.completed, "window_s": run.window_s,
        "latency_ms_p50": float(np.median(lat)) * 1e3 if len(lat) else None,
        "pool_frames": plan["pool_frames"], "pool_bytes": plan["pool_bytes"],
        "mpix_per_s_by_quarter": quarter_rates(run),
        "setup_phases_s": phases,
        "check_s": check_s, "traced_requests": n_traced,
        "traced_call_ms": traced_call_ms(run),
        "host": {"cores": None if cores.CORES is None else
                 {k: sorted(v) for k, v in cores.CORES.items()},
                 "main_core_mhz_before_after": mhz}}
    result["checks"] = checks
    return result


def quarter_rates(run) -> list:
    """MP/s in each quarter of the window (by completion time): a drift of
    the host's speed inside one run shows here."""
    t0, span = run.window[0], run.window_s / 4
    px = run.frames_per_request * run.pixels_per_frame
    counts = [0] * 4
    for t in run.dones:
        counts[min(3, int((t - t0) / span))] += 1
    return [c * px / span / 1e6 for c in counts] if span > 0 else []


def traced_call_ms(run) -> float | None:
    """The mean host time of a call inside the traced slice, beside
    ``entry_host_ms`` outside it: what the profiler costs the host."""
    if run.traced is None or not run.call_ends:
        return None
    a, b = run.traced
    if b <= a:
        return None
    return sum(run.call_ends[i] - run.starts[i] for i in range(a, b)) \
        / (b - a) * 1e3


def main(argv=None) -> int:
    args = parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness.device import split_cores

    split_cores()
    cell, driver, plan, readers = prepare(args.workload, args.seed,
                                          bool(args.trace))
    pin_caches()
    from portbench.harness.device import power_limit, require_cards

    require_cards(cell.chips)
    import torch

    from portbench.harness import procs, program
    from portbench.harness.check import check_lines

    device = torch.device("cuda", 0)
    result = measure(cell, driver, plan, readers, seconds=args.seconds,
                     trace=bool(args.trace), device=device,
                     make_model=program.make_model, t_start=T_START)
    info = result["info"]
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    log(f"card: {power_limit()}; host cores {info['host']['cores']}, the "
        f"timing core's clock {info['host']['main_core_mhz_before_after']} "
        f"MHz before and after the window")
    log(f"requests: {info['requests']} in {info['window_s']:.3f} s, "
        f"median latency {info['latency_ms_p50']} ms, "
        f"{result['attempted']} attempted, {result['failed']} failed")
    log(f"pool: {info['pool_frames']} frames, {info['pool_bytes']} bytes = "
        f"{info['pool_bytes'] / l2:.2f} x L2 ({l2} bytes)")
    log(f"reference check: {info['check_s']:.2f} s; traced requests: "
        f"{info['traced_requests']}, their calls {info['traced_call_ms']} "
        f"ms on the host")
    left = procs.reap()
    if left:
        log(f"portbench: ended child processes left running: {left}")
    for line in check_lines(result["checks"]):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
