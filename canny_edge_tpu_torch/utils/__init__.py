"""Timing and tracing of the port.  ``roofline.py``, ``opcount.py`` and
``constants.py`` of the JAX package read XLA HLO and TPU VMEM and have no
counterpart here; ``chip_smoke.py`` computes the kernels' bounds."""
