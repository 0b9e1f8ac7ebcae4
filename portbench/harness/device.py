"""The card: its presence, its name and power limit, and the harness's
waits on it.  A run that finds fewer cards than its cell asks for stops
before it measures anything; there is no CPU fallback.

And the host's cores: a run gives the thread that calls the program and
times it a core of its own in the window, and every other thread (the
card's runtime, PyTorch's and NumPy's pools, the profiler's) the rest, so
that the thread a run times neither moves between cores nor shares one."""

from __future__ import annotations

import os
import subprocess
import sys
import time

CORES: dict | None = None     # role -> set of cores, once split


def split_cores() -> None:
    """Split the cores this process may use into ``main`` (the last) and
    ``rest``, and move the calling thread, and so every thread it starts
    from now on, to ``rest``.  Nothing is pinned where fewer than two cores
    are allowed."""
    global CORES
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        CORES = None
        return
    CORES = {"main": {cores[-1]}, "rest": set(cores[:-1])}
    pin("rest")


def pin(role: str) -> None:
    """Move the calling thread (alone: Linux pins threads one by one) to
    the cores of ``role``; a no-op before :func:`split_cores`."""
    if CORES is not None:
        os.sched_setaffinity(0, CORES[role])


def cpu_mhz() -> float | None:
    """The timing core's clock (core 0 before the split) as
    ``/proc/cpuinfo`` reports it, or None where it reports none."""
    core = str(min(CORES["main"])) if CORES is not None else "0"
    try:
        with open("/proc/cpuinfo") as f:
            blocks = f.read().split("\n\n")
    except OSError:
        return None
    for block in blocks:
        fields = {k.strip(): v.strip() for k, _, v in
                  (line.partition(":") for line in block.splitlines())}
        if fields.get("processor") == core and "cpu MHz" in fields:
            return float(fields["cpu MHz"])
    return None


def require_cards(n: int) -> None:
    """Exit with code 2, saying why, unless ``n`` cards are there."""
    import torch

    if not torch.cuda.is_available():
        why = ("no CUDA device (torch.cuda.is_available() is False); the "
               "benchmark measures the card and never runs on the CPU")
    elif torch.cuda.device_count() < n:
        why = (f"the cell needs {n} CUDA devices, torch.cuda.device_count() "
               f"is {torch.cuda.device_count()}")
    else:
        return
    print(f"portbench: {why}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out[0] if out else "nvidia-smi gave nothing"


class Waits:
    """Completion markers on ``device``: a ring of CUDA events on the card,
    nothing on the CPU (where every call has finished when it returns)."""

    def __init__(self, device, ring: int):
        import torch

        self.cuda = device.type == "cuda"
        self.device = device
        self.events = ([torch.cuda.Event() for _ in range(ring)]
                       if self.cuda else [None] * ring)

    def mark(self, i: int):
        ev = self.events[i % len(self.events)]
        if ev is not None:
            ev.record()
        return ev

    @staticmethod
    def wait(ev) -> float:
        """Wait for ``ev``; the time its completion was observed."""
        if ev is not None:
            ev.synchronize()
        return time.perf_counter()

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)
