"""PyTorch / CUDA port of canny_edge_tpu: the ``fused``, ``pallas`` and
``xla`` Canny paths on an NVIDIA H100, with hand-written CUDA kernels for
the front end (K1), the packed hysteresis flood (K2), the tiled-dilation
hysteresis (K3) and the banded raster-scan hysteresis (K4), each beside its
plain PyTorch version; the unpacked stage path (``with_intermediates``,
``SobelTorch``); and the command line (``python -m canny_edge_tpu_torch.cli``)
with its frame sources, native feeder, streaming runner, timing and trace.

Imports neither JAX nor the JAX package.
"""

from . import golden  # noqa: F401  (JAX's package exports it)
from .models.canny import CannyTorch
from .models.sobel import SobelTorch

__all__ = ["CannyTorch", "SobelTorch"]
