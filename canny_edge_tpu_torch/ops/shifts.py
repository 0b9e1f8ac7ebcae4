"""Static shifts of a tensor's last two axes: the counterpart of
``canny_edge_tpu/ops/shifts.py``.  A stencil is a sum or an OR of shifted
copies: zero-filled (``shift_cols`` / ``shift_rows``) or edge-replicated
(``clamp_shift_cols`` / ``clamp_shift_rows``, the reference's Sobel
clamp)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_cols(x: torch.Tensor, off: int, fill=0) -> torch.Tensor:
    """y[..., j] = x[..., j + off] where valid, ``fill`` elsewhere."""
    w = x.shape[-1]
    if off == 0:
        return x
    if abs(off) >= w:
        return torch.full_like(x, fill)
    if off > 0:
        return F.pad(x[..., off:], (0, off), value=fill)
    return F.pad(x[..., :w + off], (-off, 0), value=fill)


def shift_rows(x: torch.Tensor, off: int, fill=0) -> torch.Tensor:
    """y[..., i, :] = x[..., i + off, :] where valid, ``fill`` elsewhere."""
    h = x.shape[-2]
    if off == 0:
        return x
    if abs(off) >= h:
        return torch.full_like(x, fill)
    if off > 0:
        return F.pad(x[..., off:, :], (0, 0, 0, off), value=fill)
    return F.pad(x[..., :h + off, :], (0, 0, -off, 0), value=fill)


def clamp_shift_cols(x: torch.Tensor, off: int) -> torch.Tensor:
    """Shift by one column with edge replication (``off`` is +-1)."""
    if off == 1:
        return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    if off == -1:
        return torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    raise ValueError(off)


def clamp_shift_rows(x: torch.Tensor, off: int) -> torch.Tensor:
    """Shift by one row with edge replication (``off`` is +-1)."""
    if off == 1:
        return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    if off == -1:
        return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    raise ValueError(off)
