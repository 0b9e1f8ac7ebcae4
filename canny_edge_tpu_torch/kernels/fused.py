"""The ``pallas`` backend's pipeline: K1 in NMS mode, then one of four
hysteresis engines (``canny_edge_tpu/kernels/fused.py:canny_fused``).

On a CUDA tensor every stage is a hand-written kernel except the
``"packed-xla"`` flood, which is plain PyTorch as it was XLA on the TPU: a
frame, or a ``(B, H, W)`` batch (JAX's ``vmap``), is two launches, K1 and
the engine (K2, K3 or K4, each with its thresholds, packing, sweeps and
unpacking in one cooperative kernel), and nothing comes back to the host
inside the call.  On a CPU tensor every
wrapper runs its plain version.  JAX's ``interpret=``
has no counterpart: the tensor's device takes its role.  A tensor stays
where it lies; a NumPy frame goes to ``device``, the card by default.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.packed import hysteresis_packed
from .frontend import frontend
from .hysteresis import hysteresis_dilate
from .hysteresis_packed import hysteresis_packed_nm
from .hysteresis_v2 import hysteresis_banded

IMPLS = ("packed", "packed-xla", "banded", "dilate")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card must exist to be named."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain PyTorch versions")
    return device


def to_device(img, device) -> torch.Tensor:
    """A tensor as it is; anything else (a NumPy frame) onto ``device``."""
    if isinstance(img, torch.Tensor):
        return img
    frame = torch.from_numpy(np.ascontiguousarray(img))
    return frame.to(resolve_device(device))


def taps_tensor(kernel_vals, device) -> torch.Tensor:
    """The float32 Gaussian taps (a sequence, an array or a tensor) as a
    tensor on ``device``; a tensor already there is returned as it is."""
    if isinstance(kernel_vals, torch.Tensor):
        return kernel_vals.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(kernel_vals, np.float32).copy()).to(device)


def canny_fused(img, min_val, max_val, *, kernel_vals, hysteresis_steps=4,
                tile=None, hysteresis_impl: str = "packed",
                strict: bool = False, device="cuda") -> torch.Tensor:
    """uint8 (H, W) or (B, H, W) -> int16 {0, 255}, on ``img``'s device.

    ``img``: a tensor, which runs where it lies, or a NumPy array, which is
    moved to ``device`` (default the card; ``RuntimeError`` when there is
    none; ``device="cpu"`` runs the plain versions).

    ``kernel_vals``: the float32 Gaussian taps (a sequence, an array or a
    tensor).  ``hysteresis_steps`` is accepted and unused, as in JAX.
    ``tile``: the ``"dilate"`` engine's tile (the TPU front-end tile has no
    counterpart in K1 and changes no result).  ``hysteresis_impl``:
    "packed" (K2, the default), "packed-xla" (the plain packed flood),
    "banded" (K4) or "dilate" (K3).  ``strict``: strict-reference
    hysteresis, packed engines only.  A batch is one launch of each stage,
    every frame converging on its own.
    """
    del hysteresis_steps
    if hysteresis_impl not in IMPLS:
        raise ValueError(f"unknown hysteresis_impl {hysteresis_impl!r}; "
                         f"expected one of {IMPLS}")
    if strict and hysteresis_impl not in ("packed", "packed-xla"):
        raise ValueError("strict mode: use hysteresis_impl packed/packed-xla")
    img = to_device(img, device)
    nm = frontend(img, taps_tensor(kernel_vals, img.device))
    if hysteresis_impl == "packed":
        return hysteresis_packed_nm(nm, min_val, max_val, strict=strict)
    if hysteresis_impl == "packed-xla":
        return hysteresis_packed(nm, min_val, max_val, strict=strict)
    if hysteresis_impl == "banded":
        return hysteresis_banded(nm, min_val, max_val)
    return hysteresis_dilate(nm, min_val, max_val,
                             **({} if tile is None else {"tile": tile}))
