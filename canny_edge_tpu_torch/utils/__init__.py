"""Timing, tracing, tuned constants, the op count and the roofline of the
port, with the names ``canny_edge_tpu.utils`` exports: ``timing.py`` (its
``PipelineReport``, ``profile_stages``, ``throughput_chained``),
``trace.py``, ``constants.py`` (knobs and the card's geometry),
``opcount.py`` (the plain versions' operations a pixel, counted under a
dispatch mode) and ``roofline.py`` (the card's floors by stage and by
kernel).

``timing`` is imported on first use: ``ops`` and ``parallel`` import
``constants`` from this package, and ``timing`` imports them.
"""

import importlib

_TIMING_NAMES = ("PipelineReport", "profile_stages", "throughput_chained")


def __getattr__(name):
    if name == "timing" or name in _TIMING_NAMES:
        timing = importlib.import_module(f"{__name__}.timing")
        return timing if name == "timing" else getattr(timing, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
