"""PyTorch / CUDA port of canny_edge_tpu: the ``fused``, ``pallas`` and
``xla`` Canny paths on an NVIDIA H100, with hand-written CUDA kernels for
the front end (K1), the packed hysteresis flood (K2), the tiled-dilation
hysteresis (K3) and the banded raster-scan hysteresis (K4), each beside its
plain PyTorch version.

Imports neither JAX nor the JAX package.
"""

from .models.canny import CannyTorch

__all__ = ["CannyTorch"]
