"""Wrapper of K1, the front-end kernel (``csrc/frontend.cu``).

uint8 ``(H, W)`` -> int16 NMS magnitude ``(H, W)``, or, with thresholds,
the packed uint32 ``(weak, strong)`` masks ``(H, ceil(W/32))``
(:func:`frontend`), and the same for a ``(B, H, W)`` batch in one launch
(JAX's ``vmap`` over its kernel); the same for one block of a larger image,
given its window with the halo (:func:`frontend_block`, K1's block mode).
A uint16 frame or batch goes into the masks only (its magnitudes, up to
370,727, pass the int16 map), through instantiations of its own, which
the C entries choose by the frame's bytes a pixel (``itemsize``, 1 or 2);
block mode takes uint8.
Any odd window, on one of three paths (:func:`k1_path`): the tile path
(every stage in one block's shared memory, unrolled per window) takes
windows 3 to 103, the ring path (column strips streamed through a ring of
x-pass rows) every wider window that its shared memory holds
(:func:`max_window`, 613 on the H100; its launch's geometry:
:func:`ring_geometry`), the scratch path every wider one (the blur through
device memory, kept per device, stream and shape as :mod:`._scratch` keeps
the floods'; then the same back half).  A CPU tensor goes to the plain version
(:mod:`..ops.window`, a frame at a time); a CUDA tensor goes to the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops.packed import cdiv
from ..ops.thresholds import threshold_bound
from ..ops.window import frontend_block as frontend_block_plain
from ..ops.window import frontend_nm as frontend_plain
from ..utils import trace
from . import _build
from ._scratch import Scratch

# kernel launches made by this wrapper (the main path's proof of use): all,
# those in block mode, those on a batch of two frames or more, and those on
# the ring and the scratch paths (windows from 105 taps); and the uint16
# frames those launches read (a launch plan's counted as its own)
launches = 0
block_launches = 0
batch_launches = 0
ring_launches = 0
scratch_launches = 0
u16_frames = 0
# what the ring launches ran (:func:`ring_geometry`): blocks, segments (the
# prologues run), x-pass rows and output rows, summed over their blocks;
# x-pass rows over output rows is the ring's recompute
ring_blocks = 0
ring_segments = 0
ring_xpass_rows = 0
ring_out_rows = 0

# the tile path's instantiations (csrc/frontend.cu:TILE_MAX): past 103 taps
# the ring path is the faster on the H100
TILE_WINDOWS = tuple(range(3, 104, 2))

MAX_BATCH = 65535    # frames a launch: the grid's z limit
# the scratch path's float32 scratch a launch at most (1 GiB): a batch
# whose frames need more runs in chunks of fewer frames
SCRATCH_FLOATS = 1 << 28

_max_window: dict[tuple, int] = {}
_scratch = Scratch()
# the frame types K1 takes, by their bytes a pixel
ITEMSIZE = {torch.uint8: 1, torch.uint16: 2}


def k1_path(window: int, max_window: int) -> str:
    """The path K1 takes at ``window`` taps on a card whose tile and ring
    paths take windows up to ``max_window``: ``"tile"`` (3 to 103, every
    stage in one block's shared memory), ``"ring"`` (a column strip through
    a ring of x-pass rows) or ``"scratch"`` (the blur through device memory,
    then the same back half)."""
    if window > max_window:
        return "scratch"
    return "tile" if window in TILE_WINDOWS else "ring"


def scratch_floats(b: int, oh: int, ow: int, window: int) -> int:
    """float32 scratch of one scratch-path launch on ``b`` outputs of ``(oh,
    ow)``: the divisors, the row blur of ``oh + 4 + 2 (window // 2)`` rows
    and the floored blur, each ``ow + 4`` wide (``csrc/frontend.cu:
    large_of``)."""
    nx, ny = ow + 4, oh + 4
    return -(-(nx + ny) // 4) * 4 + b * nx * (2 * ny + 2 * (window // 2))


def max_window(device: torch.device, itemsize: int = 1) -> int:
    """The largest window K1's tile and ring paths take on ``device`` (a
    CUDA device) for frames of ``itemsize`` bytes a pixel, as its shared
    memory allows (asked of the library once a device and type); a wider
    one takes the scratch path."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, itemsize)
    if key not in _max_window:
        with _build.device_guard(torch.device("cuda", idx)):
            _max_window[key] = _build.load(
                "frontend").canny_frontend_max_window(itemsize)
    return _max_window[key]


class RingGeometry(NamedTuple):
    """A ring-path launch (``csrc/frontend.cu:ring_launch_of``): the blocks
    the card holds at once (``slots``), the 64-column ``strips`` of a
    frame, the launch's ``segments`` (the parts of the blocks' spans of
    32-row steps that lie in one strip of one frame, each with its own
    prologue), the ``steps`` of its longest block, the grid's ``blocks``,
    and, summed over the blocks, the x-pass rows computed (a segment's
    32-row steps and its prologue of ``4 + 2 (window // 2)`` rows) and the
    output rows.  Equal runs down each strip give one segment a block;
    spans that cross strips and frames, one block a slot, more."""
    slots: int
    strips: int
    segments: int
    steps: int
    blocks: int
    xpass_rows: int
    out_rows: int


def ring_geometry(b: int, oh: int, ow: int, window: int,
                  device: torch.device, itemsize: int = 1) -> RingGeometry:
    """K1's ring-path launch on ``b`` outputs of ``(oh, ow)`` at ``window``
    taps on ``device`` (a CUDA device), for frames of ``itemsize`` bytes a
    pixel, as the library launches it; ``RuntimeError`` for a window off
    the ring path."""
    geo = (ctypes.c_longlong * 7)()
    with _build.device_guard(device):
        err = _build.load("frontend").canny_frontend_ring_geometry(
            b, oh, ow, window, geo, itemsize)
    _build.check(err, "canny_frontend_ring_geometry")
    return RingGeometry(*geo)


def _check_taps(taps: torch.Tensor) -> int:
    window = taps.shape[0] if taps.dim() == 1 else 0
    if taps.dtype != torch.float32 or window % 2 != 1:
        raise ValueError("taps must be a 1-D float32 tensor of odd length")
    return window


def threshold_bounds(thresholds):
    """The thresholds as the integers that the kernel and the plain
    version both compare with (:func:`..ops.thresholds.threshold_bound`)."""
    if thresholds is None:
        return None
    return tuple(threshold_bound(t) for t in thresholds)


def k1_bound(t: int, itemsize: int = 1) -> int:
    """A bound as K1 compares it: 4 * magnitude with 4 * bound in an int;
    the magnitudes of a frame of ``itemsize`` bytes a pixel lie in [0,
    2**13) for uint8, in [0, 2**19) for uint16 (up to 370,727), so the
    bound clamped to [-1, 2**13], or to [-1, 2**19], decides alike."""
    return min(max(t, -1), 1 << 13 if itemsize == 1 else 1 << 19)


def _launch(src: torch.Tensor, taps: torch.Tensor, thresholds, geom, entry,
            lead=(), prep=None):
    """Check the device, allocate the outputs, launch K1 on ``geom = (B,
    halo, oh, ow, row0, col0, H, W)``: the tile or ring path through
    ``entry = (name, args)`` where the window allows it, else the scratch
    path.  ``prep``: the caller's open ``k1.prep`` span, which ends at the
    launch."""
    dev = src.device
    if dev.type != "cuda" or taps.device != dev:
        raise ValueError(f"image on {dev} and taps on {taps.device}: "
                         f"both must be on the same CUDA device")
    window = taps.shape[0]
    itemsize = ITEMSIZE[src.dtype]
    taps = taps.contiguous()
    b, halo, oh, ow, row0, col0, H, W = geom
    if thresholds is None:
        nm = torch.empty((*lead, oh, ow), dtype=torch.int16, device=dev)
        out = (0, 0, 0, nm.data_ptr(), None, None)
    else:
        weak = torch.empty((*lead, oh, cdiv(ow, 32)), dtype=torch.uint32,
                           device=dev)
        strong = torch.empty_like(weak)
        out = (1, k1_bound(thresholds[0], itemsize),
               k1_bound(thresholds[1], itemsize), None,
               weak.data_ptr(), strong.data_ptr())
    path = k1_path(window, max_window(dev, itemsize))
    with _build.device_guard(dev):
        lib = _build.load("frontend")
        stream = _build.stream_handle(dev)
        if path != "scratch":
            name, args = entry
            args = (src.data_ptr(), *args, taps.data_ptr(), window, *out,
                    stream)
        else:
            name = "canny_frontend_large"
            n = scratch_floats(b, oh, ow, window)
            scr = _scratch.lookup(dev, stream, (b, oh, ow, window))
            if scr is None:
                scr = _scratch.create(dev, stream, (b, oh, ow, window), 0)
                scr["floats"] = torch.empty(n, dtype=torch.float32,
                                            device=dev)
            args = (src.data_ptr(), itemsize, *geom, taps.data_ptr(),
                    window, *out,
                    scr["floats"].data_ptr(), n, stream)
        if prep:
            trace.end("k1.prep", prep)
        run = trace.RECORDING and trace.begin()
        err = getattr(lib, name)(*args)
    _build.check(err, f"{name} launch")
    if run:
        trace.end("k1.launch", run)
    return path, (nm if thresholds is None else (weak, strong))


def ring_counts(b: int, oh: int, ow: int, window: int, dev,
                itemsize: int = 1) -> tuple:
    """What a launch on ``b`` outputs of ``(oh, ow)`` of ``itemsize``-byte
    pixels at ``window`` taps on ``dev`` adds to ``ring_launches``,
    ``ring_blocks``, ``ring_segments``, ``ring_xpass_rows`` and
    ``ring_out_rows``: one launch and its geometry (:func:`ring_geometry`)
    on the ring path, zeros on the others."""
    if k1_path(window, max_window(dev, itemsize)) != "ring":
        return (0, 0, 0, 0, 0)
    g = ring_geometry(b, oh, ow, window, dev, itemsize)
    return (1, g.blocks, g.segments, g.xpass_rows, g.out_rows)


def count_ring(counts: tuple) -> None:
    """Add :func:`ring_counts`'s ``counts`` to the ring counters."""
    global ring_launches, ring_blocks, ring_segments, ring_xpass_rows, \
        ring_out_rows
    n, blocks, segments, xpass_rows, out_rows = counts
    ring_launches += n
    ring_blocks += blocks
    ring_segments += segments
    ring_xpass_rows += xpass_rows
    ring_out_rows += out_rows


def _count(path: str, geom, window: int, dev, block: bool = False,
           itemsize: int = 1) -> None:
    """A launch of :func:`_launch` on ``geom``."""
    global launches, block_launches, batch_launches, scratch_launches, \
        u16_frames
    b, _, oh, ow = geom[:4]
    launches += 1
    block_launches += block
    batch_launches += b > 1
    scratch_launches += path == "scratch"
    u16_frames += b if itemsize == 2 else 0
    if path == "ring":
        count_ring(ring_counts(b, oh, ow, window, dev, itemsize))


def frontend(img: torch.Tensor, taps: torch.Tensor, thresholds=None):
    """Front end on ``img``'s device; ``taps``: float32 Gaussian weights.

    ``img``: uint8 ``(H, W)`` or a batch ``(B, H, W)`` whose results stack
    the frames' (one launch on the card for up to ``MAX_BATCH`` frames, a
    launch a chunk of that many above it; on the scratch path, chunks whose
    scratch stays within ``SCRATCH_FLOATS``), or uint16 with
    ``thresholds``.  Any odd window: up to :func:`max_window` the tile or
    ring path, above it the scratch path.  ``thresholds``: optional
    ``(min_val, max_val)``, compared as JAX compares an integer map with
    them (:func:`threshold_bounds`).
    """
    prep = trace.RECORDING and trace.begin()
    thresholds = threshold_bounds(thresholds)
    if img.dtype not in ITEMSIZE or img.dim() not in (2, 3) \
            or img.numel() == 0:
        raise ValueError(f"expected a non-empty uint8 or uint16 (H, W) "
                         f"image or (B, H, W) batch, got {img.dtype} "
                         f"{tuple(img.shape)}")
    if img.dtype == torch.uint16 and thresholds is None:
        raise ValueError("expected a non-empty uint8 image or batch for the "
                         "NMS map: a uint16 frame's magnitudes pass the "
                         "int16 map, so K1 takes one into the packed masks "
                         "only (backend 'fused', component mode)")
    window = _check_taps(taps)
    itemsize = ITEMSIZE[img.dtype]
    if img.device.type == "cpu":
        if prep:
            trace.end("k1.prep", prep)
        run = trace.RECORDING and trace.begin()
        host_taps = taps.cpu().numpy()
        res = [frontend_plain(f, host_taps, thresholds)
               for f in (img if img.dim() == 3 else (img,))]
        if thresholds is None:
            res = [r.to(torch.int16) for r in res]
        if run:
            trace.end("k1.launch", run)
        if img.dim() == 2:
            return res[0]
        return (torch.stack(res) if thresholds is None else
                tuple(torch.stack(m) for m in zip(*res)))
    img = img.contiguous()
    h, w = img.shape[-2:]
    per_launch = MAX_BATCH
    if img.dim() == 3 and k1_path(window, max_window(img.device, itemsize)) \
            == "scratch":
        per_launch = max(1, min(MAX_BATCH, SCRATCH_FLOATS
                                // scratch_floats(1, h, w, window)))
    parts = []
    for chunk in (img.split(per_launch) if img.dim() == 3 else (img,)):
        if parts:
            prep = trace.RECORDING and trace.begin()
        b = chunk.shape[0] if chunk.dim() == 3 else 1
        geom = (b, 0, h, w, 0, 0, h, w)
        path, res = _launch(chunk, taps, thresholds, geom,
                            ("canny_frontend", (itemsize, b, h, w)),
                            chunk.shape[:-2], prep)
        parts.append(res)
        _count(path, geom, window, img.device, itemsize=itemsize)
    if len(parts) == 1:
        return parts[0]
    return (torch.cat(parts) if thresholds is None else
            tuple(torch.cat(m) for m in zip(*parts)))


def frontend_nm(img: torch.Tensor, kernel_vals, *, tile=None, interpret=None,
                indexing: str = "element", border: str = "strips"):
    """JAX's K1 wrapper under its name and keywords
    (``canny_edge_tpu/kernels/frontend.py:frontend_nm``): uint8 ``(H, W)``
    (or a batch) -> int16 NMS magnitude, :func:`frontend` with the taps
    ``kernel_vals`` (a sequence, an array or a tensor) on ``img``'s device.

    ``tile``, ``interpret`` and ``indexing`` are accepted and unused: they
    chose the TPU kernel's tiles, its interpreter and its ``BlockSpec``
    indexing, none of which changes the result.  ``border`` takes only
    ``"strips"``, the exact border: JAX's ``"none"`` leaves the border
    frame wrong, for profiling, and the port has no such variant.
    """
    del tile, interpret, indexing
    if border != "strips":
        raise ValueError(f"border={border!r}: only the exact border "
                         f"('strips') exists here")
    if not isinstance(kernel_vals, torch.Tensor):
        kernel_vals = torch.from_numpy(
            np.asarray(kernel_vals, np.float32).copy())
    return frontend(img, kernel_vals.to(device=img.device,
                                        dtype=torch.float32))


def frontend_block(window: torch.Tensor, row0: int, col0: int, H: int,
                   W: int, taps: torch.Tensor, thresholds=None):
    """Front end of one ``(hl, wl)`` block of an ``(H, W)`` image whose
    pixel ``(row0, col0)`` is the block's first, on ``window``'s device.

    ``window``: uint8 ``(hl + 2r, wl + 2r)`` with ``r = len(taps) // 2 +
    2``, zero past the image; the result is the block's int16 NMS map
    ``(hl, wl)``, or with ``thresholds`` its packed ``(weak, strong)``
    masks ``(hl, ceil(wl/32))``; pixels past the image are 0 and clear.
    """
    prep = trace.RECORDING and trace.begin()
    thresholds = threshold_bounds(thresholds)
    r = _check_taps(taps) // 2 + 2
    hl, wl = window.shape[-2] - 2 * r, window.shape[-1] - 2 * r
    if window.dtype != torch.uint8 or window.dim() != 2 or hl < 1 or wl < 1:
        raise ValueError(f"expected a uint8 window with a halo of {r}, got "
                         f"{window.dtype} {tuple(window.shape)}")
    if row0 < 0 or col0 < 0 or H < 1 or W < 1:
        raise ValueError(f"block at ({row0}, {col0}) of a {H}x{W} image")
    if window.device.type == "cpu":
        if prep:
            trace.end("k1.prep", prep)
        run = trace.RECORDING and trace.begin()
        res = frontend_block_plain(window, row0, col0, H, W,
                                   taps.cpu().numpy(), thresholds)
        if run:
            trace.end("k1.launch", run)
        return res.to(torch.int16) if thresholds is None else res
    geom = (1, r, hl, wl, row0, col0, H, W)
    path, res = _launch(window.contiguous(), taps, thresholds, geom,
                        ("canny_frontend_block",
                         (hl, wl, r, row0, col0, H, W)), prep=prep)
    _count(path, geom, taps.shape[0], window.device, block=True)
    return res
