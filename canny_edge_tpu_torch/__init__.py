"""PyTorch / CUDA port of canny_edge_tpu: the ``fused`` Canny path on an
NVIDIA H100, with hand-written CUDA kernels for the front end (K1) and the
packed hysteresis flood (K2), each beside its plain PyTorch version.

Imports neither JAX nor the JAX package.
"""

from .models.canny import CannyTorch

__all__ = ["CannyTorch"]
