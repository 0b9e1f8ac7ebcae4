"""``entry_host_ms`` (ms, host clock): the mean time a call into the entry
point takes on the host, from the call to its return (validation, the
wrappers and the launches, not the card's work), over the calls outside
the traced slice, which the profiler would slow."""

import numpy as np


def read(run):
    idx = [i for i in run.untraced() if i < len(run.call_ends)]
    if not idx:
        return None
    starts = np.asarray(run.starts)[idx]
    ends = np.asarray(run.call_ends)[idx]
    return float(np.mean(ends - starts)) * 1e3
