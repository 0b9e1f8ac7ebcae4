"""Exact scalar arithmetic: the counterpart of
``canny_edge_tpu/ops/numerics.py``.  The TPU had no correctly rounded
float32 division and the package built one from integer residuals; eager
PyTorch's float32 ``/`` is IEEE on the CPU and on the card, so here the
division is the operator.  The integer square root and the angle bins are
those of the front end and the stage path."""

from __future__ import annotations

import torch

from .stages import quantize_angle as quantize_angle_int  # noqa: F401
from .window import isqrt as isqrt_int32  # noqa: F401


def exact_div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a / b``."""
    return a.to(torch.float32) / b.to(torch.float32)
