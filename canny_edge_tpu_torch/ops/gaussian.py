"""Gaussian taps of the reference blur, computed on the host in NumPy.

A copy of ``canny_edge_tpu.golden.reference.gaussian_window`` /
``gaussian_kernel`` (the reference's ``src/utils.cpp:77-95``): this package
keeps its own so that it never imports the JAX package.  The taps are the
model's only state; :meth:`CannyTorch.from_numpy_params` accepts them from
elsewhere.
"""

from __future__ import annotations

import math

import numpy as np


def gaussian_window(sigma: float) -> int:
    """Kernel width ``1 + 2*ceil(3*sigma)`` with a float32 ``3*sigma``."""
    three_sigma = np.float32(3) * np.float32(sigma)
    return int(1 + 2 * math.ceil(float(three_sigma)))


def gaussian_kernel(sigma: float) -> np.ndarray:
    """float32 Gaussian weights normalized to sum 1.

    Per tap ``exp(-(x*x)/(2*sigma*sigma)) / (sqrt(6.2831853)*sigma)``: the
    exp argument is float32, ``expf`` is taken as the correctly rounded
    float64 ``exp`` of that float32 argument (NumPy's float32 ``exp``
    differs by 1 ulp on much of this domain), and the division is float64
    before rounding to float32.  The normalizer is the sequential float32
    tap sum.
    """
    window = gaussian_window(sigma)
    center = window // 2
    sig = np.float32(sigma)
    denom = np.float32(np.float32(2) * sig * sig)
    x = (np.arange(window) - center).astype(np.float32)
    arg = -(x * x / denom)
    e = np.exp(arg.astype(np.float64)).astype(np.float32)
    d = math.sqrt(6.2831853) * float(sig)
    product = (e.astype(np.float64) / d).astype(np.float32)
    s = np.float32(0.0)
    for i in range(window):
        s = np.float32(s + product[i])
    return (product / s).astype(np.float32)


def kernel_sum(kernel) -> np.float32:
    """Sequential float32 tap sum: the blur's interior divisor.

    It is not 1.0 for most sigmas (one ulp off for 0.5, 1.4, 2.0, 3.0).
    """
    s = np.float32(0)
    for t in range(len(kernel)):
        s = np.float32(s + np.float32(kernel[t]))
    return s
