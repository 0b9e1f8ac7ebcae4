"""Torch's intra-op threads for the port's CPU tests: a worker's share of
the cores.

Under pytest-xdist every worker would run torch's default pool, a thread
a core, so ``-n 6`` on 8 cores puts 48 threads on them, and each of the
thousands of small parallel regions in a plain flood (``ops/dilate.py``)
waits on the other workers' threads: minutes where one thread a worker
takes seconds.  At import this module sets torch's threads to the cores
this process may run on divided by the number of workers
(``PYTEST_XDIST_WORKER_COUNT``, which xdist sets in each worker), at least
one; a run without xdist keeps every core.  :func:`child_env` hands the
same share to a child process that runs torch.

The port's test files import it as ``torch_threads``, never from
``tests.``: on the card's machine another ``tests`` package shadows this
directory's.  The library sets no thread count: that is its user's
choice.
"""

import os

import torch

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)


def child_env() -> dict:
    """This process's environment with ``OMP_NUM_THREADS`` at its share,
    for a child that runs torch."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS))
