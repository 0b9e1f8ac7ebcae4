"""Sobel edge model: blur and gradient magnitude thresholded, no NMS or
hysteresis (``canny_edge_tpu/models/sobel.py:SobelTPU``).

The stages are those of :mod:`..ops.stages`, plain PyTorch on the model's
device: the card by default, the CPU with ``device="cpu"``.  The functional
entry points (:func:`sobel_fn`, :func:`sobel_magnitude_fn`) run where their
input tensor lies; a NumPy input goes to ``device``.
"""

from __future__ import annotations

import torch

from ..kernels.fused import resolve_device, to_device
from ..ops import stages
from ..ops.gaussian import gaussian_kernel
from ..ops.thresholds import at_least, threshold_int32
from .canny import uint8_input

# SobelTPU's bound; the largest magnitude is floor(sqrt(2) * 1020) = 1442
MAX_THRESHOLD = 1443


def sobel_magnitude_fn(img, *, kernel_vals, device="cuda") -> torch.Tensor:
    """uint8 (..., H, W) -> int16 gradient magnitude of the blurred image
    (the reference's 'Edge Image' display, src/utils.cpp:454-462), where
    ``img`` lies (a NumPy input goes to ``device``, the card by default)."""
    smoothed = stages._gaussian_blur_with_kernel(to_device(img, device),
                                                 kernel_vals)
    return stages.magnitude(smoothed).to(torch.int16)


def sobel_fn(img, threshold: int, *, kernel_vals,
             device="cuda") -> torch.Tensor:
    """uint8 (..., H, W) -> int16 {0, 255}: 255 where the magnitude of the
    blurred image is at least ``threshold``; placement as in
    :func:`sobel_magnitude_fn`."""
    mag = sobel_magnitude_fn(img, kernel_vals=kernel_vals, device=device)
    return at_least(mag, threshold).to(torch.int16) * 255


class SobelTorch:
    """Blur + Sobel magnitude edge model.

    Example::

        model = SobelTorch(sigma=1.0)            # on the card
        edges = model(img_u8, threshold=80)      # (H, W) int16 {0, 255}
        mag = model.magnitude(img_u8)            # (H, W) int16

    Inputs may be NumPy arrays or tensors; outputs are tensors on
    ``device`` ("cuda" by default, which raises without a card; "cpu").
    The threshold is truncated to int32 as ``SobelTPU`` does; :func:`sobel_fn`
    compares it as JAX compares.
    """

    def __init__(self, sigma: float = 1.0, device="cuda"):
        self.sigma = sigma
        self.kernel = gaussian_kernel(sigma)
        self.device = resolve_device(device)

    def _input(self, img, ndim: int):
        if img.ndim != ndim:
            raise ValueError("batch expects (B, H, W)" if ndim == 3
                             else "expected a (H, W) image")
        return uint8_input(img, self.device)

    @staticmethod
    def _check_threshold(threshold):
        if not (0 <= threshold <= MAX_THRESHOLD):
            raise ValueError(f"threshold must be in [0, {MAX_THRESHOLD}]")

    def __call__(self, img, threshold: int) -> torch.Tensor:
        self._check_threshold(threshold)
        return sobel_fn(self._input(img, 2), threshold_int32(threshold),
                        kernel_vals=self.kernel)

    def batch(self, imgs, threshold: int) -> torch.Tensor:
        """(B, H, W) -> (B, H, W) int16 {0, 255}."""
        self._check_threshold(threshold)
        return sobel_fn(self._input(imgs, 3), threshold_int32(threshold),
                        kernel_vals=self.kernel)

    def magnitude(self, img) -> torch.Tensor:
        return sobel_magnitude_fn(self._input(img, 2), kernel_vals=self.kernel)
