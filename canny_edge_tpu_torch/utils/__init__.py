"""Timing and tracing of the port, with the names ``canny_edge_tpu.utils``
exports.  ``roofline.py``, ``opcount.py`` and ``constants.py`` of the JAX
package read XLA HLO and TPU VMEM and have no counterpart here;
``chip_smoke.py`` computes the kernels' bounds."""

from . import timing  # noqa: F401
from .timing import PipelineReport, profile_stages, throughput_chained  # noqa: F401
