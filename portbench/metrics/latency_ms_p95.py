"""``latency_ms_p95`` (ms, host clock): the 95th percentile, over every
request of the window, of the time from its call's start on the host to
the moment its completion was observed."""

import numpy as np


def read(run):
    lat = run.latencies_s()
    if lat.size == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
