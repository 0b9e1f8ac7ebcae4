"""Wrapper of K2, the packed hysteresis flood (``csrc/hysteresis_packed.cu``).

Two inputs and two outputs, every combination one kernel call on the card:

* :func:`hysteresis_packed`: packed uint32 weak/strong masks
  ``(H, ceil(W/32))`` -> the packed edge mask, or with ``edges_int16=True``
  the int16 ``{0, 255}`` edge map ``(H, W)``;
* :func:`hysteresis_packed_nm`: an int16/int32 NMS map with the two
  thresholds (``hysteresis_impl="packed"``) -> the int16 edge map, or with
  ``packed_out=True`` the packed edge mask.

Each takes a batch too, ``(B, ...)`` with a leading frame axis, in one call
whose tile space holds every frame (JAX's ``vmap`` over its flood); each
frame converges on its own.  A CPU tensor goes to the plain version,
composed of :mod:`..ops.packed`'s ``pack_mask``, ``hysteresis_packed_masks``
and ``unpack_edges``, a frame at a time; a CUDA tensor goes to the kernel,
for every shape from 1x1 up, or raises.  On the card the thresholds, the
packing and the unpacking run in the kernel's own file, never in plain
PyTorch.

Every launch adds its flood steps to a word of its card, on the card, and
every call of the plain version adds its rounds to :data:`cpu_steps`, in
the same unit: :func:`flood_steps` reads the total.
"""

from __future__ import annotations

import torch

from ..ops.packed import cdiv, hysteresis_packed_masks, pack_mask, unpack_edges
from ..ops.thresholds import at_least, threshold_bound
from ..utils import trace
from . import _build
from ._scratch import Scratch, buffer, next_token

# kernel launches made by this wrapper (the main path's proof of use): all,
# those with the strict fix off (0, 0) (a halo-extended block), and those on
# a batch of two frames or more
launches = 0
quirk_launches = 0
batch_launches = 0
# flood rounds of the plain version, the most any frame of a call needed;
# a card's launches add their grid-wide steps to that card's word in
# _step_words
cpu_steps = 0

_scratch = Scratch()
_step_words: dict[int, torch.Tensor] = {}


def flood_steps() -> int:
    """The flood steps run so far in this process, a call's count each: a
    launch's grid-wide steps (the kernel steps until no frame of its batch
    changes), summed on its card, and a plain call's rounds, the most any
    of its frames needed.  Over a stretch of calls, the count less the
    count before, over the launches (:data:`launches`) less those before,
    is the steps a launch.  Waits for every card that has launched K2."""
    total = cpu_steps
    for idx, word in _step_words.items():
        torch.cuda.synchronize(idx)
        total += int(word.item())
    return total


def _step_word(dev) -> torch.Tensor:
    """The card's int64 word that its launches add their steps to."""
    word = _step_words.get(dev.index)
    if word is None:
        word = _step_words[dev.index] = torch.zeros(1, dtype=torch.int64,
                                                    device=dev)
    return word


def _launch(dev, b, h, w, *, weak=None, strong=None, nm=None, lo=0, hi=0,
            int16_out, strict, quirk_rw=(0, 0), lead=(), prep=None):
    """One call of the kernel on ``b`` frames (``lead``: the output's leading
    axes); returns ``(output, steps)`` with ``steps`` a 0-d view of the
    scratch that the next call on this shape overwrites.  ``prep``: the
    caller's open ``k2.prep`` span, which ends at the launch."""
    global launches, quirk_launches, batch_launches
    lib = _build.load("hysteresis_packed")
    with _build.device_guard(dev):
        stream = _build.stream_handle(dev)
        entry = _scratch.lookup(dev, stream, (b, h, w))
        if entry is None:
            entry = _scratch.create(
                dev, stream, (b, h, w),
                lib.canny_hysteresis_packed_scratch_words(b, h, w))
        if nm is not None:
            weak = buffer(entry, "weak", b * h, w, dev)
            strong = buffer(entry, "strong", b * h, w, dev)
        if int16_out:
            out = torch.empty((*lead, h, w), dtype=torch.int16, device=dev)
            edges = buffer(entry, "edges", b * h, w, dev)
        else:
            out = edges = torch.empty((*lead, h, cdiv(w, 32)),
                                      dtype=torch.uint32, device=dev)
        total = _step_word(dev)
        if prep:
            trace.end("k2.prep", prep)
        run = trace.RECORDING and trace.begin()
        err = lib.canny_hysteresis_packed(
            weak.data_ptr(), strong.data_ptr(),
            None if nm is None else nm.data_ptr(),
            0 if nm is None else nm.element_size(), lo, hi,
            edges.data_ptr(), out.data_ptr() if int16_out else None, b, h, w,
            int(bool(strict)), *quirk_rw, entry["ctl"].data_ptr(),
            total.data_ptr(), next_token(), stream)
    _build.check(err, "canny_hysteresis_packed launch")
    if run:
        trace.end("k2.launch", run)
    launches += 1
    quirk_launches += bool(strict) and tuple(quirk_rw) != (0, 0)
    batch_launches += b > 1
    return out, entry["ctl"][-1]


def _plain(weak, strong, h, w, *, strict, quirk_rw=(0, 0), int16_out):
    """The plain version on packed masks ``(H, Wd)`` or ``(B, H, Wd)``, a
    frame at a time: ``(output, rounds)``, the most rounds any frame
    needed, as the kernel counts its steps; they go into
    :data:`cpu_steps`."""
    global cpu_steps
    outs, rounds = [], 0
    for wf, sf in zip(weak.reshape(-1, *weak.shape[-2:]),
                      strong.reshape(-1, *strong.shape[-2:])):
        out, steps = hysteresis_packed_masks(wf, sf, h, w, strict=strict,
                                             quirk_rw=quirk_rw)
        rounds = max(rounds, steps)
        outs.append(unpack_edges(out, w) if int16_out else out)
    cpu_steps += rounds
    return (outs[0] if weak.dim() == 2 else torch.stack(outs)), rounds


def _frames(t: torch.Tensor, what: str) -> int:
    """The frames of a 2-D input (1) or of a 3-D batch, or ValueError."""
    if t.dim() == 2:
        return 1
    if t.dim() == 3 and t.shape[0] >= 1:
        return t.shape[0]
    raise ValueError(f"{what}: expected (H, ...) or (B, H, ...) with B >= 1, "
                     f"got {tuple(t.shape)}")


def hysteresis_packed(weak: torch.Tensor, strong: torch.Tensor, height: int,
                      width: int, *, strict: bool = False, quirk_rw=(0, 0),
                      return_steps: bool = False, edges_int16: bool = False):
    """Flood ``weak`` from ``strong`` to the fixed point.

    ``weak``, ``strong``: uint32 ``(height, ceil(width/32))``, or a batch
    ``(B, height, ceil(width/32))`` whose frames are flooded each on its own
    in one call.  ``strict``: the strict-reference exclusion of the
    promotion (1,0) -> (0,1), where pixel (0, 0) of the image lies at
    ``quirk_rw`` = (row, word) of the masks (``(1, 1)`` on a block extended
    by a halo of one row and one word; the caller then says whether the
    whole image has a pixel (0, 1)); in a batch, of every frame.
    ``edges_int16``: return the int16 {0, 255} edge map ``(..., height,
    width)`` instead of the packed mask.  ``return_steps`` (one frame only):
    also return the number of flood steps (kernel: grid-wide steps, a 0-d
    device tensor; CPU: the plain version's rounds).
    """
    prep = trace.RECORDING and trace.begin()
    shape = (height, cdiv(width, 32))
    b = _frames(weak, "weak")
    if weak.dim() == 3:
        shape = (b, *shape)
    for name, t in (("weak", weak), ("strong", strong)):
        if t.dtype != torch.uint32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be uint32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if height < 1 or width < 1:
        raise ValueError(f"empty image {height}x{width}")
    if weak.device != strong.device:
        raise ValueError("weak and strong lie on different devices")
    if return_steps and weak.dim() == 3:
        raise ValueError("return_steps takes one frame")
    strict = strict and height >= 2 and width >= 2
    if strict and not (0 <= quirk_rw[0] < shape[-2]
                       and 0 <= quirk_rw[1] < shape[-1]):
        raise ValueError(f"quirk_rw {tuple(quirk_rw)} outside the masks "
                         f"{shape[-2:]}")
    if weak.device.type == "cpu":
        if prep:
            trace.end("k2.prep", prep)
        run = trace.RECORDING and trace.begin()
        out, steps = _plain(weak, strong, height, width, strict=strict,
                            quirk_rw=quirk_rw, int16_out=edges_int16)
        if run:
            trace.end("k2.launch", run)
    elif weak.device.type == "cuda":
        out, steps = _launch(
            weak.device, b, height, width, weak=weak.contiguous(),
            strong=strong.contiguous(), int16_out=edges_int16, strict=strict,
            quirk_rw=quirk_rw, lead=weak.shape[:-2], prep=prep)
        if return_steps:
            steps = steps.clone()
    else:
        raise ValueError(f"unsupported device {weak.device}")
    return (out, steps) if return_steps else out


def hysteresis_packed_pallas_masks(weak_p: torch.Tensor,
                                   strong_p: torch.Tensor, height: int,
                                   width: int, *, inner_dilate: int = 19,
                                   interpret=None, layout: str = "transposed",
                                   vmem_budget=None, strict: bool = False,
                                   quirk_rw=(0, 0)):
    """JAX's flood of packed masks under its name and keywords
    (``canny_edge_tpu/kernels/hysteresis_packed.py:
    hysteresis_packed_pallas_masks``): :func:`hysteresis_packed`, K2 on a
    CUDA tensor.  Returns the packed edge mask.

    ``inner_dilate``, ``interpret``, ``layout`` and ``vmem_budget`` are
    accepted and unused: they chose the TPU kernel's dilations a round, its
    interpreter, its VMEM layout and its VMEM budget (with a fallback to
    the XLA flood past it), none of which changes the result; K2 floods any
    shape in tiles of 8 x 32 words.
    """
    del inner_dilate, interpret, layout, vmem_budget
    return hysteresis_packed(weak_p, strong_p, height, width, strict=strict,
                             quirk_rw=quirk_rw)


def hysteresis_packed_nm(nm: torch.Tensor, min_val: int, max_val: int, *,
                         inner_dilate: int = 19, strict: bool = False,
                         packed_out: bool = False,
                         return_steps: bool = False):
    """int16/int32 NMS magnitude (H, W) or (B, H, W) -> int16 {0, 255}.

    The counterpart of ``canny_edge_tpu/kernels/hysteresis_packed.py:
    hysteresis_packed_pallas``.  ``weak = nm >= min_val`` and ``strong = nm
    >= max_val``, compared signed as JAX compares them (a float threshold
    in float32: :func:`..ops.thresholds.threshold_bound`).  On the card the
    compares, the packing, the flood and the unpacking are one kernel call,
    for a batch too (each frame converging on its own); on the CPU they are
    the plain versions, a frame at a time.  ``packed_out``: return the packed uint32 edge mask
    instead.  ``return_steps`` (one frame only): as in
    :func:`hysteresis_packed`.  ``inner_dilate`` is accepted and unused, as
    by :func:`hysteresis_packed_pallas_masks`.
    """
    del inner_dilate
    prep = trace.RECORDING and trace.begin()
    if nm.dim() not in (2, 3) or nm.numel() == 0 \
            or nm.dtype not in (torch.int16, torch.int32):
        raise ValueError("expected a non-empty int16/int32 (H, W) or (B, H, W) "
                         f"NMS map, got {nm.dtype} {tuple(nm.shape)}")
    if return_steps and nm.dim() == 3:
        raise ValueError("return_steps takes one frame")
    b, (h, w) = _frames(nm, "nm"), nm.shape[-2:]
    strict = strict and h >= 2 and w >= 2
    # the kernel and the plain version compare the same integers
    min_val, max_val = (threshold_bound(t, nm.dtype)
                        for t in (min_val, max_val))
    if nm.device.type == "cpu":
        if prep:
            trace.end("k2.prep", prep)
        run = trace.RECORDING and trace.begin()
        out, steps = _plain(pack_mask(at_least(nm, min_val)),
                            pack_mask(at_least(nm, max_val)), h, w,
                            strict=strict, int16_out=not packed_out)
        if run:
            trace.end("k2.launch", run)
    elif nm.device.type == "cuda":
        out, steps = _launch(nm.device, b, h, w, nm=nm.contiguous(),
                             lo=min_val, hi=max_val,
                             int16_out=not packed_out, strict=strict,
                             lead=nm.shape[:-2], prep=prep)
        if return_steps:
            steps = steps.clone()
    else:
        raise ValueError(f"unsupported device {nm.device}")
    return (out, steps) if return_steps else out
