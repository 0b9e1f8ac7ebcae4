"""Plain PyTorch ops: Gaussian taps, the front end, the packed flood and the
unpacked stage path, with the names ``canny_edge_tpu.ops`` exports."""

from . import numerics, packed, shifts, stages, window  # noqa: F401
from .numerics import exact_div_f32, isqrt_int32, quantize_angle_int  # noqa: F401
from .stages import (  # noqa: F401
    gaussian_blur,
    hysteresis,
    nonmax_suppression,
    sobel,
    xy_gradient,
)
