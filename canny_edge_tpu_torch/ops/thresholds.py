"""How a threshold is read: the two rules of ``canny_edge_tpu``.

* The model classes (``CannyTPU``, ``SobelTPU``, ``ShardedCanny``) call
  ``jnp.int32(t)`` before anything compares: a float truncates toward zero
  (:func:`threshold_int32`).
* Everything else compares ``x >= t`` under JAX's promotion: an integer map
  against an integer compares as integers, against a float in float32.  For
  an integral map value ``n`` with ``|n| < 2**24`` that is ``n >= k`` with
  ``k = ceil(float32(t))``; NaN and +inf mark no pixel, -inf every pixel
  (:func:`threshold_bound`, :func:`at_least`).

Every kernel wrapper and its plain version take the integer of
:func:`threshold_bound`, so the two compare the same value by
construction; the kernels compare it with an ``int`` in C.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _host(t):
    """``t`` with a tensor read to the host as a Python number (a CUDA
    tensor costs one host read, as ``int(t)`` does)."""
    return t.item() if isinstance(t, torch.Tensor) else t


def threshold_int32(t) -> int:
    """What ``jnp.int32(t)`` gives: an integer as it is (``OverflowError``
    past int32 for a Python int), a float truncated toward zero
    (``ValueError`` for NaN, ``OverflowError`` for an infinity or a Python
    float past int32), a NumPy scalar or a 0-d tensor as NumPy converts
    it."""
    if type(t) is int and INT32_MIN <= t <= INT32_MAX:
        return t                         # np.int32's value, without it
    return int(np.int32(_host(t)))


def threshold_bound(t, dtype: torch.dtype = torch.int32) -> int:
    """The integer ``k`` such that ``n >= t`` under JAX's promotion holds
    exactly when ``n >= k``, for every value ``n`` of an integer map of
    ``dtype`` with ``|n| < 2**24``.

    An integer (a Python int, a bool, a NumPy integer, a 0-d integer
    tensor) stays as it is; a float is first rounded to float32, then
    ceiled; NaN and +inf give the bound above every value, -inf the one
    below every value.  ``k`` is clamped to what a C ``int`` and ``dtype``
    carry: ``[max(min, INT32_MIN), min(max + 1, INT32_MAX)]`` of ``dtype``,
    so an int16 map's "no pixel" is 32768, exact for every int16 value.  An
    int32 map's is ``INT32_MAX``, which marks only the value ``INT32_MAX``
    itself; no map of this package comes near it (an NMS magnitude is below
    ``2**13``).
    """
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, INT32_MIN), min(info.max + 1, INT32_MAX)
    t = _host(t)
    if isinstance(t, (bool, int, np.integer, np.bool_)):
        k = int(t)
    else:
        f = np.float32(t)
        if math.isnan(f):
            k = hi
        elif math.isinf(f):
            k = hi if f > 0 else lo
        else:
            k = math.ceil(f)
    return min(max(k, lo), hi)


def at_least(x: torch.Tensor, t) -> torch.Tensor:
    """``x >= t`` for an integer map ``x``, as JAX compares it: ``x >=``
    :func:`threshold_bound` ``(t, x.dtype)``, with the bound past the
    dtype's largest value marking no pixel (PyTorch would wrap it)."""
    k = threshold_bound(t, x.dtype)
    if k > torch.iinfo(x.dtype).max:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return x >= k
