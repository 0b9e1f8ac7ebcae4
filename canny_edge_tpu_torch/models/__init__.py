"""The models and their functional entry points, with the names
``canny_edge_tpu.models`` exports (``CannyTorch`` and ``SobelTorch`` stand
for ``CannyTPU`` and ``SobelTPU``)."""

from .canny import (CannyTorch, canny_fn, canny_fn_batched,  # noqa: F401
                    canny_fn_packed, canny_with_intermediates)
from .sobel import SobelTorch, sobel_fn, sobel_magnitude_fn  # noqa: F401

__all__ = ["CannyTorch", "SobelTorch", "canny_fn", "canny_fn_batched",
           "canny_fn_packed", "canny_with_intermediates", "sobel_fn",
           "sobel_magnitude_fn"]
