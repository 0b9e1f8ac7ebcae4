"""``torch.profiler`` capture around any pipeline call
(``canny_edge_tpu/utils/trace.py``): a Chrome trace, viewable in Perfetto,
with the card's kernels when the trace is on the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

from ..kernels.fused import resolve_device


@contextlib.contextmanager
def trace(out_dir: str | None = None, device="cuda"):
    """Trace the enclosed block into ``out_dir/trace.json``.

    ``device``: "cuda" (default; the host and the card, ``RuntimeError``
    without one) or "cpu" (the host only).  ``out_dir`` defaults to
    ``canny_torch_trace`` in the temporary directory.  Yields ``out_dir``::

        with trace("traces/run1"):
            model(img, 50, 150)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                      "canny_torch_trace")
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield out_dir
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def annotate(name: str):
    """A named region inside a trace."""
    from torch.profiler import record_function

    return record_function(name)
