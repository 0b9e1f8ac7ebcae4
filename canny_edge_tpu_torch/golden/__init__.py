"""The NumPy oracle (``canny_edge_tpu.golden``): the port's own copy, with
every name the JAX package exports."""

from .reference import (  # noqa: F401
    EDGE,
    NOEDGE,
    canny,
    find_edge_pixels,
    gaussian_blur,
    gaussian_kernel,
    gaussian_window,
    hysteresis,
    hysteresis_bfs,
    hysteresis_strict,
    magnitude_int,
    nonmax_suppression,
    quantize_angle,
    quantize_angle_cpp_float,
    sobel,
    xy_gradient,
)
