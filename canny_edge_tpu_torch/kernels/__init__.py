"""Hand-written CUDA kernels (csrc/) and their wrappers, with the names
``canny_edge_tpu.kernels`` exports: ``frontend_nm`` is K1, ``canny_fused``
the ``pallas`` backend's pipeline, ``hysteresis_pallas`` K3 (the tiled
dilation) and ``hysteresis_packed_pallas`` K2 from an NMS map."""

from . import frontend, fused, hysteresis, hysteresis_packed  # noqa: F401
from .frontend import frontend as frontend_nm  # noqa: F401
from .fused import canny_fused  # noqa: F401
from .hysteresis import hysteresis_dilate as hysteresis_pallas  # noqa: F401
from .hysteresis_packed import hysteresis_packed_nm  # noqa: F401

hysteresis_packed_pallas = hysteresis_packed_nm
