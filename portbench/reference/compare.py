"""The comparison that decides ``correct``: each sampled output of the timed
path against the frozen oracle (:mod:`.oracle`) on the same frame.

The oracle runs on the host, after the window, in worker processes, one
frame a task.  A task is the frame, the configuration's sigma, thresholds
and hysteresis mode, and every output the program gave for that frame; its
answer is, for each output, the number of pixels that differ from the
oracle's map and the first of them.  A worker is a fresh interpreter
(:func:`serve`) that reads its pickled tasks on standard input and writes
their answers on standard output; the caller waits for every worker, and
kills any still running when it leaves on an error.  No ``multiprocessing``:
its pools leave a resource tracker process running until the caller exits.
Imports only NumPy and SciPy (through the oracle): nothing of the program.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

from . import oracle

SERIAL_PIXELS = 2_000_000
ROOT = Path(__file__).resolve().parents[2]
WORKER = [sys.executable, "-c",
          "from portbench.reference.compare import serve; serve()"]


def oracle_edges(frame: np.ndarray, sigma: float, min_val: int, max_val: int,
                 mode: str) -> np.ndarray:
    """The oracle's int16 {0, 255} map of one uint8 or uint16 frame."""
    smoothed = oracle.gaussian_blur(frame, sigma)
    nm = oracle.nonmax_suppression(*oracle.sobel(smoothed))
    if mode == "strict-reference":
        return oracle.hysteresis_strict(nm, min_val, max_val)
    if mode != "component":
        raise ValueError(f"unknown hysteresis mode {mode!r}")
    return oracle.hysteresis(nm, min_val, max_val)


def judge(task) -> list[tuple[int, tuple | None]]:
    """``task``: ``(frame, sigma, min_val, max_val, mode, outputs)``; for
    each output ``(differing pixels, first differing (row, col) or None)``.
    An output of another shape or type differs at every pixel."""
    frame, sigma, min_val, max_val, mode, outputs = task
    ref = oracle_edges(frame, sigma, min_val, max_val, mode)
    res = []
    for out in outputs:
        out = np.asarray(out)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            res.append((int(ref.size), None))
            continue
        diff = out != ref
        n = int(np.count_nonzero(diff))
        first = tuple(int(v) for v in np.argwhere(diff)[0]) if n else None
        res.append((n, first))
    return res


def judge_all(tasks: list, workers: int | None = None) -> list:
    """:func:`judge` of every task, in ``workers`` worker processes (by
    default one a task, at most one a core: the measuring process only
    waits; none under ``SERIAL_PIXELS`` frame pixels in all, where starting
    them would cost more than the work), task ``i`` in worker ``i %
    workers``; every worker has ended when this returns or raises."""
    if not tasks:
        return []
    if workers is None:
        pixels = sum(t[0].size for t in tasks)
        workers = 1 if pixels < SERIAL_PIXELS else \
            max(1, min(len(tasks), os.cpu_count() or 1))
    workers = min(workers, len(tasks))
    if workers == 1:
        return [judge(t) for t in tasks]
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = []
    try:
        for _ in range(workers):
            procs.append(subprocess.Popen(
                WORKER, cwd=ROOT, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE))
        for w, p in enumerate(procs):
            pickle.dump(tasks[w::workers], p.stdin,
                        protocol=pickle.HIGHEST_PROTOCOL)
            p.stdin.close()
        answers = []
        for w, p in enumerate(procs):
            out = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"oracle worker {w} exited with code "
                                   f"{p.returncode}")
            answers.append(pickle.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                f.close()
    return [answers[i % workers][i // workers] for i in range(len(tasks))]


def serve() -> None:
    """A worker of :func:`judge_all`: pickled tasks in on standard input,
    their answers out on standard output (which nothing else writes to)."""
    out, sys.stdout = sys.stdout.buffer, sys.stderr
    tasks = pickle.load(sys.stdin.buffer)
    pickle.dump([judge(t) for t in tasks], out,
                protocol=pickle.HIGHEST_PROTOCOL)
    out.flush()
