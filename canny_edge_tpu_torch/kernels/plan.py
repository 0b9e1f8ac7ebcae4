"""Launch plans: a request of the ``fused`` pipeline on the card, K1 with
the thresholds then K2, in one C call (``csrc/frontend.cu:
canny_run_plan``).

A plan is built at a configuration's first request and kept, keyed by
everything its launches depend on but the input and the output
(:func:`plan_key`): the device, the stream, the input's shape (``(H, W)``
or ``(B, H, W)``), the taps (where they lie and their layout), K1's two
bounds as it compares them, the strict rule as K2 applies it (the fix
needs two rows and two columns; pixel (0, 0) of every frame is the
quirk's) and the output kind (the int16 map or the packed words).  It
holds the rest: K2's scratch entry (:mod:`._scratch`: its control words
and the packed weak, strong and edges buffers, which K1 writes its masks
straight into), the card's step word, K1's path, and the argument block of
``canny_run_plan`` in host memory, K2's C entry among its fields.

A request then costs a lookup, a token and one ctypes call, made with the
interpreter lock held, so that no other thread's launch comes between a
plan's K1 and its K2; both go on the plan's stream, which orders the reuse
of its buffers, as :mod:`._scratch` relies on.  Its output is fresh (the
caller keeps it): one ``torch.empty`` a request, made for the plan's next
request once this one's launches are queued, while the card runs them,
and kept by the plan till then (a plan's first request makes its own), so
that the allocation is not on the host's way to K1.  At most
:data:`MAX_PLANS` are kept, the least recently used going first.

A request takes a plan where :func:`applies` says so, which is asked when
a key is not found (a key holds all it reads): a non-empty uint8 or uint16
CUDA tensor of at most :data:`.frontend.MAX_BATCH` frames, with taps that
take K1's tile or ring path (3 to :func:`.frontend.max_window` taps for
the frame's type); every other request keeps the wrappers' path.  The
wrappers' counters (K1's ``launches``, ``batch_launches``,
``u16_frames``, ``ring_launches`` and the ring's geometry,
``ring_blocks``, ``ring_segments``, ``ring_xpass_rows``,
``ring_out_rows``, which a plan works out once, at its build; K2's
``launches``, ``batch_launches``) and
:func:`.hysteresis_packed.flood_steps` count a plan's launches as theirs;
:data:`plan_builds` and :data:`plan_hits` count its lookups, so
``plan_hits / (plan_hits + plan_builds)`` is the hit share.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.packed import cdiv
from ..utils import trace
from . import _build
from . import frontend as _k1
from . import hysteresis_packed as _k2
from ._scratch import buffer, next_token
from .frontend import k1_bound

MAX_PLANS = 8        # the least recently used plan goes first

# lookups that built a plan, and those that found one
plan_builds = 0
plan_hits = 0

_plans: dict = {}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

_P = ctypes.c_void_p
# canny_run_plan with the interpreter lock held (a PYFUNCTYPE)
_RUN = ctypes.PYFUNCTYPE(ctypes.c_int, _P, _P, _P, ctypes.c_ulonglong)


class Args(ctypes.Structure):
    """``csrc/frontend.cu:Plan``, field for field."""
    _fields_ = [*((n, _P) for n in ("taps", "weak", "strong", "edges",
                                   "scratch", "total_steps", "stream",
                                   "flood")),
                *((n, ctypes.c_int) for n in ("device", "B", "H", "W",
                                              "window", "mn", "mx",
                                              "strict", "isz"))]


class Plan:
    """A built plan: its argument block and what a request needs of it."""
    __slots__ = ("args", "addr", "run", "shape", "dtype", "device", "batch",
                 "u16_frames", "ring", "keep", "spare")


def applies(img: torch.Tensor, taps: torch.Tensor) -> bool:
    """Whether a request on ``img`` with ``taps`` takes a launch plan: a
    non-empty uint8 or uint16 ``(H, W)`` frame or ``(B, H, W)`` batch of at
    most :data:`.frontend.MAX_BATCH` frames on a card, and float32 taps,
    1-D and contiguous on the same card, of an odd window from 3 taps up to
    :func:`.frontend.max_window` for the frame's type."""
    if not img.is_cuda or img.dtype not in _k1.ITEMSIZE:
        return False
    idx = img.get_device()
    if taps.get_device() != idx or taps.dtype != torch.float32 \
            or taps.dim() != 1 or not taps.is_contiguous():
        return False
    shape = img.shape
    if len(shape) not in (2, 3) or not img.numel() \
            or len(shape) == 3 and shape[0] > _k1.MAX_BATCH:
        return False
    window = taps.shape[0]
    return window % 2 == 1 and 3 <= window <= _k1.max_window(
        torch.device("cuda", idx), _k1.ITEMSIZE[img.dtype])


def plan_key(idx: int, stream: int, img: torch.Tensor, taps: torch.Tensor,
             bounds, strict: bool, packed: bool) -> tuple:
    """What a plan is keyed by: the device index, the stream handle, the
    input's shape and dtype, the taps (address, shape, strides, dtype,
    device), K1's bounds as it compares them (:func:`.frontend.k1_bound`),
    the strict rule where K2 applies it (two rows and two columns at
    least) and the output kind.  It holds all that :func:`applies` reads,
    so a key found is a request that takes its plan."""
    shape, dtype = img.shape, img.dtype
    itemsize = dtype.itemsize
    return (idx, stream, shape, dtype, taps.data_ptr(), taps.shape,
            taps.stride(), taps.dtype, taps.get_device(),
            k1_bound(bounds[0], itemsize), k1_bound(bounds[1], itemsize),
            strict and len(shape) >= 2 and shape[-2] >= 2 and shape[-1] >= 2,
            packed)


def run(img: torch.Tensor, taps: torch.Tensor, bounds, strict: bool,
        packed: bool) -> torch.Tensor | None:
    """K1 then K2 on ``img``'s plan: the int16 ``{0, 255}`` map of
    ``img``'s shape, or with ``packed`` its uint32 words ``(..., H,
    ceil(W/32))``; None where no plan applies (:func:`applies`), and the
    caller takes the wrappers' path.  ``bounds``: K1's two thresholds as
    :func:`.frontend.threshold_bounds` gives them (an int32 integer is its
    own bound)."""
    global plan_builds, plan_hits
    if not img.is_cuda:
        return None
    prep = trace.RECORDING and trace.begin()
    idx = img.get_device()
    stream = _raw_stream(idx) if _raw_stream is not None else \
        torch.cuda.current_stream(idx).cuda_stream
    key = plan_key(idx, stream, img, taps, bounds, strict, packed)
    plan = _plans.pop(key, None)
    if plan is not None:
        plan_hits += 1
    elif applies(img, taps) and not (strict and img.dtype == torch.uint16):
        plan = _build_plan(key)
        plan_builds += 1
        while len(_plans) >= MAX_PLANS:
            _plans.pop(next(iter(_plans)))
    else:
        return None
    _plans[key] = plan                 # most recently used last
    if not img.is_contiguous():
        img = img.contiguous()
    spare = plan.spare             # list.pop: no two threads take one output
    out = spare.pop() if spare else \
        torch.empty(plan.shape, dtype=plan.dtype, device=plan.device)
    token = next_token()
    if prep:
        trace.end("plan.prep", prep)
    launch = trace.RECORDING and trace.begin()
    err = plan.run(plan.addr, img.data_ptr(), out.data_ptr(), token)
    if err:
        _fail(plan, err)
    if launch:
        trace.end("plan.launch", launch)
    _count(plan)
    if not spare:
        spare.append(torch.empty(plan.shape, dtype=plan.dtype,
                                 device=plan.device))
    return out


def _count(plan: Plan, k2: bool = True) -> None:
    """A plan's launches in the wrappers' counters: K1's, and K2's."""
    _k1.launches += 1
    _k1.batch_launches += plan.batch
    _k1.u16_frames += plan.u16_frames
    _k1.count_ring(plan.ring)
    if k2:
        _k2.launches += 1
        _k2.batch_launches += plan.batch


def _fail(plan: Plan, err: int) -> None:
    """Raise the error of the launch that failed, as its wrapper raises
    it; K1's launch counts where K2's failed."""
    if err > 0:
        _build.check(err, "canny_frontend launch")
    _count(plan, k2=False)
    _build.check(-err, "canny_hysteresis_packed launch")


def _build_plan(key: tuple) -> Plan:
    """The plan of ``key`` (:func:`plan_key`): K2's scratch entry and
    buffers on the key's device and stream, the output's shape, the
    argument block."""
    idx, stream, shape, dtype, taps_ptr, taps_shape, _, _, _, mn, mx, \
        strict, packed = key
    itemsize = _k1.ITEMSIZE[dtype]
    dev = torch.device("cuda", idx)
    b, (h, w) = (shape[0] if len(shape) == 3 else 1), shape[-2:]
    k1, k2 = _build.load("frontend"), _build.load("hysteresis_packed")
    entry = _k2._scratch.lookup(dev, stream, (b, h, w))
    if entry is None:
        entry = _k2._scratch.create(
            dev, stream, (b, h, w),
            k2.canny_hysteresis_packed_scratch_words(b, h, w))
    weak = buffer(entry, "weak", b * h, w, dev)
    strong = buffer(entry, "strong", b * h, w, dev)
    edges = None if packed else buffer(entry, "edges", b * h, w, dev)
    word = _k2._step_word(dev)
    window = taps_shape[0]
    plan = Plan()
    plan.args = Args(
        taps_ptr, weak.data_ptr(), strong.data_ptr(),
        None if edges is None else edges.data_ptr(), entry["ctl"].data_ptr(),
        word.data_ptr(), stream,
        ctypes.cast(k2.canny_hysteresis_packed, _P).value, idx, b, h, w,
        window, mn, mx, int(strict), itemsize)
    plan.addr = ctypes.addressof(plan.args)
    plan.run = _RUN(("canny_run_plan", k1))
    if packed:
        plan.shape, plan.dtype = (*shape[:-1], cdiv(w, 32)), torch.uint32
    else:
        plan.shape, plan.dtype = tuple(shape), torch.int16
    plan.device = dev
    plan.batch = b > 1
    plan.u16_frames = b if itemsize == 2 else 0
    plan.ring = _k1.ring_counts(b, h, w, window, dev, itemsize)
    plan.keep = (entry, word)          # the buffers live as long as the plan
    plan.spare = []
    return plan
