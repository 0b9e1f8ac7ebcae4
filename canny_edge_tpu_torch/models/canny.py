"""Single-device Canny on PyTorch: ``canny_edge_tpu/models/canny.py``'s
functional entry points (:func:`canny_fn`, :func:`canny_fn_packed`,
:func:`canny_fn_batched`, :func:`canny_with_intermediates`) and the model
that calls them, :class:`CannyTorch` (``CannyTPU``).

``backend="fused"``: K1 (front end with the threshold compares and the
32-to-1 packing) -> K2 (packed hysteresis flood, which also writes the
int16 {0, 255} map), all in :func:`_fused`: on the card, where K1's tile or
ring path takes the window, one C call from a launch plan kept per
configuration (:mod:`..kernels.plan`).  ``"pallas"``:
:func:`..kernels.fused.canny_fused` (K1 in NMS mode, then K2 through its
NMS-map entry).  ``"xla"``: the plain front end and the plain packed flood,
no kernel.  The ``packed`` entry points run the fused engines whatever the
backend, as in JAX.  Every function runs where its input tensor lies: on a
CUDA tensor the stages are the hand-written kernels, on a CPU tensor the
same wrappers run their plain PyTorch versions; a NumPy input goes to
``device``, the card unless ``device="cpu"``.  A ``(B, H, W)`` batch on
``fused`` or ``pallas`` is one launch of each stage, every frame converging
on its own (JAX's ``vmap`` and ``lax.map``); ``xla`` runs it a frame at a
time.  ``with_intermediates`` runs the unpacked stage path of
:mod:`..ops.stages` in plain PyTorch wherever the input lies.

Frames are uint8; ``fused`` (and ``xla``) in component mode also take
uint16 ones (K1's uint16 instantiations, or the plain versions on the
CPU), whose magnitudes reach 370,727: the model classes then take
thresholds up to 65535.  ``pallas`` (K1's int16 NMS map), the strict mode
and ``with_intermediates`` refuse them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import plan
from ..kernels.frontend import frontend, threshold_bounds
from ..kernels.fused import canny_fused, resolve_device, taps_tensor, to_device
from ..kernels.hysteresis_packed import hysteresis_packed
from ..ops import stages
from ..ops.gaussian import gaussian_kernel
from ..ops.packed import cdiv
from ..ops.packed import hysteresis_packed as hysteresis_packed_plain
from ..ops.thresholds import threshold_int32
from ..ops.window import frontend_nm
from ..utils import trace

MODES = ("component", "strict-reference")
BACKENDS = ("fused", "pallas", "xla")


U8 = (np.uint8, torch.uint8)
U16 = (np.uint16, torch.uint16)
# what a model or entry point that refuses a uint16 frame says of it
WIDE_TAKEN = ("uint16 frames are taken by backend 'fused' (or 'xla') in "
              "component mode")


def check_uint8(img) -> None:
    """``TypeError`` unless ``img`` (an array or a tensor) is uint8, with
    ``CannyTPU``'s message."""
    if img.dtype not in U8:
        raise TypeError("input image must be uint8 grayscale")


def uint8_input(img, device) -> torch.Tensor:
    """A model's uint8 input (an array or a tensor) as a tensor on
    ``device``, after :func:`check_uint8`."""
    check_uint8(img)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return img.to(device)


def _truncated(min_val, max_val) -> tuple[int, int]:
    """The thresholds as the model classes of JAX pass them on:
    ``jnp.int32`` of each, a float truncated toward zero."""
    return threshold_int32(min_val), threshold_int32(max_val)


def _strict(hysteresis_mode: str) -> bool:
    if hysteresis_mode not in MODES:
        raise ValueError(f"unknown hysteresis mode: {hysteresis_mode!r}")
    return hysteresis_mode == "strict-reference"


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")


def _empty(img: torch.Tensor, backend: str, packed: bool = False):
    """JAX's result on an input without a pixel whose width is not 0, else
    None: a frame of no rows or a batch of them on ``xla`` and ``fused``, a
    batch of no frames of at least one row on every backend, is an int16
    map of the input's shape (``packed``: the uint32 words of such a map,
    whatever the backend) on the input's device.  JAX refuses a width of 0,
    and no rows on ``pallas``; so do the kernels and the plain version."""
    if img.numel() or img.dim() not in (2, 3):
        return None
    h, w = img.shape[-2:]
    if w == 0 or (backend == "pallas" and h == 0 and not packed):
        return None
    if packed:
        return torch.zeros((*img.shape[:-1], cdiv(w, 32)), dtype=torch.uint32,
                           device=img.device)
    return torch.zeros(img.shape, dtype=torch.int16, device=img.device)


def _host_taps(kernel_vals) -> np.ndarray:
    """The taps as float32 host values (the plain front end's argument)."""
    if isinstance(kernel_vals, torch.Tensor):
        return kernel_vals.detach().cpu().numpy().astype(np.float32)
    return np.asarray(kernel_vals, np.float32)


def canny_fn(img, min_val, max_val, *, kernel_vals, hysteresis_steps=4,
             backend: str = "xla", hysteresis_mode: str = "component",
             device="cuda") -> torch.Tensor:
    """uint8 (H, W) or (B, H, W) -> int16 {0, 255}, where ``img`` lies
    (uint16 on ``fused`` and ``xla`` in component mode).

    ``img``: a tensor, which runs where it lies, or a NumPy array, which
    goes to ``device`` (the card by default, ``RuntimeError`` without one;
    ``"cpu"``).  ``kernel_vals``: the float32 Gaussian taps (a sequence, an
    array or a tensor; a tensor on ``img``'s device saves a copy a call).
    ``hysteresis_steps`` is accepted and unused, as by JAX's production
    backends.  ``backend``: "xla" (the default, as in JAX: the plain front
    end and the plain packed flood), "fused" (K1 with the thresholds, then K2
    to int16) or "pallas" (:func:`..kernels.fused.canny_fused`: K1 to the NMS
    map, then K2).  ``hysteresis_mode``: "component" or "strict-reference".
    A batch goes to :func:`canny_fn_batched`.  A frame of no rows gives an
    empty map, as JAX's does (:func:`_empty`).
    """
    del hysteresis_steps
    root = trace.RECORDING and trace.entry()
    try:
        chk = root and trace.begin()
        strict = _strict(hysteresis_mode)
        _check_backend(backend)
        img = to_device(img, device)
        out = _empty(img, backend)
        if chk:
            trace.end("entry.check", chk)
        if out is not None:
            return out
        if img.dim() == 3:
            return canny_fn_batched(img, min_val, max_val,
                                    kernel_vals=kernel_vals, backend=backend,
                                    hysteresis_mode=hysteresis_mode)
        if backend == "xla":
            return hysteresis_packed_plain(
                frontend_nm(img, _host_taps(kernel_vals)), min_val, max_val,
                strict=strict)
        return _canny_frames(img, min_val, max_val, kernel_vals, backend,
                             strict)
    finally:
        if root:
            trace.end_entry(root)


def _canny_frames(img, min_val, max_val, kernel_vals, backend, strict):
    """The ``fused`` or ``pallas`` backend on a frame or a batch: one launch
    of each stage."""
    if backend == "pallas":
        return canny_fused(img, min_val, max_val, kernel_vals=kernel_vals,
                           strict=strict)
    return _fused(img, taps_tensor(kernel_vals, img.device),
                  threshold_bounds((min_val, max_val)), strict, False)


def _fused(img, taps, bounds, strict: bool, packed: bool) -> torch.Tensor:
    """K1 with the thresholds, then K2, on a frame or a batch where ``img``
    lies: the request's launch plan where one applies
    (:func:`..kernels.plan.run`), else K1's and K2's wrappers, one launch
    of each.  ``taps``: a float32 tensor on ``img``'s device; ``bounds``:
    K1's two integer bounds (:func:`..kernels.frontend.threshold_bounds`;
    an int32 threshold is its own).  The int16 map, or with ``packed`` the
    uint32 words; an input without a pixel gives :func:`_empty`'s."""
    out = plan.run(img, taps, bounds, strict, packed)
    if out is None:
        out = _empty(img, "fused", packed)
    if out is None and strict and img.dtype == torch.uint16:
        raise ValueError(f"strict-reference hysteresis takes uint8 frames: "
                         f"{WIDE_TAKEN}")
    if out is None:
        weak, strong = frontend(img, taps, bounds)
        out = hysteresis_packed(weak, strong, *img.shape[-2:], strict=strict,
                                edges_int16=not packed)
    return out


def canny_fn_packed(img, min_val, max_val, *, kernel_vals,
                    hysteresis_mode: str = "component",
                    device="cuda") -> torch.Tensor:
    """uint8 or uint16 (H, W) or (B, H, W) -> uint32 (..., H, ceil(W/32))
    edge bitmask (bit b of word j = column 32j + b), where ``img`` lies: K1
    with the thresholds, then K2, whose packed state is the output (no
    unpack); a batch is one launch of each.  ``img``, ``kernel_vals``, ``device``: as
    in :func:`canny_fn`; no rows or no frames give empty words.
    """
    root = trace.RECORDING and trace.entry()
    try:
        chk = root and trace.begin()
        strict = _strict(hysteresis_mode)
        img = to_device(img, device)
        out = _empty(img, "fused", packed=True)
        if chk:
            trace.end("entry.check", chk)
        if out is not None:
            return out
        return _fused(img, taps_tensor(kernel_vals, img.device),
                      threshold_bounds((min_val, max_val)), strict, True)
    finally:
        if root:
            trace.end_entry(root)


def canny_fn_batched(imgs, min_val, max_val, *, kernel_vals,
                     hysteresis_steps=8, hysteresis_mode="component",
                     backend="xla", device="cuda") -> torch.Tensor:
    """(B, H, W) uint8 (or uint16, as :func:`canny_fn`) -> (B, H, W) int16
    {0, 255}, each frame with its own
    convergence (JAX's ``lax.map``): on ``fused`` and ``pallas`` one launch
    of each stage for the batch, on ``xla`` :func:`canny_fn` a frame at a
    time.  Frames of no rows, or no frames, give an empty map as JAX's do
    (:func:`_empty`)."""
    root = trace.RECORDING and trace.entry()
    try:
        chk = root and trace.begin()
        strict = _strict(hysteresis_mode)
        _check_backend(backend)
        imgs = to_device(imgs, device)
        if imgs.dim() != 3:
            raise ValueError(f"expected a (B, H, W) batch, got "
                             f"{tuple(imgs.shape)}")
        out = _empty(imgs, backend)
        if chk:
            trace.end("entry.check", chk)
        if out is not None:
            return out
        if backend == "xla":
            return torch.stack([
                canny_fn(f, min_val, max_val, kernel_vals=kernel_vals,
                         hysteresis_steps=hysteresis_steps, backend=backend,
                         hysteresis_mode=hysteresis_mode) for f in imgs])
        return _canny_frames(imgs, min_val, max_val, kernel_vals, backend,
                             strict)
    finally:
        if root:
            trace.end_entry(root)


def canny_with_intermediates(img, min_val, max_val, *, kernel_vals,
                             hysteresis_steps=4):
    """The unpacked stage path with its intermediates (the ``-s`` view).

    uint8 (..., H, W) -> (edges int16, {"smoothed", "magnitude" (int16),
    "angle", "nonmax" (int16), "frontier_iterations"}), where ``img`` lies.
    ``frontier_iterations`` (an int) counts the dilations run: rounds of
    ``hysteresis_steps`` dilations, each round ending in one test of
    convergence.  The hysteresis is the component rule, as in JAX.
    """
    smoothed = stages._gaussian_blur_with_kernel(img, kernel_vals)
    mag, ang = stages.sobel(smoothed)
    nm = stages.nonmax_suppression(mag, ang)
    out, frontier = stages.hysteresis_with_stats(nm, min_val, max_val,
                                                 hysteresis_steps)
    return out, {
        "smoothed": smoothed,
        "magnitude": mag.to(torch.int16),
        "angle": ang,
        "nonmax": nm.to(torch.int16),
        "frontier_iterations": frontier,
    }


class CannyTorch:
    """Canny edge detector on one device.

    Example::

        model = CannyTorch(sigma=1.0)             # runs on the card
        edges = model(img_u8, 50, 150)            # (H, W) int16 {0,255}
        bits = model.packed(img_u8, 50, 150)      # (H, ceil(W/32)) uint32

    ``hysteresis_mode``: "component" (8-connected rule) or
    "strict-reference" (the reference BFS's missing (1,0)->(0,1) edge).
    ``device``: "cuda" (default) or "cpu" for the plain PyTorch versions.
    ``backend``: "fused" (default), "pallas" or "xla", as in ``CannyTPU``;
    all three give the same edges.  Frames are uint8, or on "fused" and
    "xla" in component mode uint16, whose thresholds may reach 65535.
    ``hysteresis_steps``: dilations between two convergence tests of
    ``with_intermediates``, whose count it also sets; the backends never
    read it.  Inputs may be NumPy arrays or
    tensors; outputs are tensors on ``device``.  Every method validates the
    thresholds, then truncates them to int32 as ``CannyTPU`` does (30.5
    means 30), where the functional entry points compare them as JAX
    compares (30.5 means 31).
    """

    def __init__(self, sigma: float = 1.0, hysteresis_mode: str = "component",
                 device="cuda", backend: str = "fused",
                 hysteresis_steps: int = 4):
        self.sigma = sigma
        self._setup(gaussian_kernel(sigma), hysteresis_mode, device, backend,
                    hysteresis_steps)

    @classmethod
    def from_numpy_params(cls, kernel: np.ndarray, *,
                          hysteresis_mode: str = "component", device="cuda",
                          backend: str = "fused", hysteresis_steps: int = 4):
        """A model with the given float32 Gaussian taps (e.g. ``CannyTPU.kernel``)."""
        model = cls.__new__(cls)
        model.sigma = None
        model._setup(kernel, hysteresis_mode, device, backend,
                     hysteresis_steps)
        return model

    def _setup(self, kernel, hysteresis_mode, device, backend,
               hysteresis_steps):
        _strict(hysteresis_mode)
        _check_backend(backend)
        kernel = np.asarray(kernel, np.float32)
        if kernel.ndim != 1 or kernel.shape[0] % 2 != 1:
            raise ValueError("kernel must be 1-D with an odd number of taps")
        device = resolve_device(device)
        # uint16 frames: the fused and xla backends, in component mode
        self._wide = backend in ("fused", "xla") and \
            hysteresis_mode == "component"
        self.hysteresis_mode = hysteresis_mode
        self.hysteresis_steps = hysteresis_steps
        self.backend = backend
        self.kernel = kernel
        self.device = device
        self.taps = torch.from_numpy(kernel.copy()).to(device)

    @property
    def window(self) -> int:
        return int(self.kernel.shape[0])

    def _input(self, img):
        """``img`` on ``device``, after the caller's dtype check (a tensor
        there already is returned as it is, by ``.to``)."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    # Each method is the root span of its request (``entry``), and its own
    # checks are ``entry.check`` (``utils/trace.py``).  A request then goes
    # once to :func:`_fused` (``packed``, or the ``fused`` backend), else to
    # the functional entry point of its backend.

    def _request(self, img, min_val, max_val, *, packed: bool, batch: bool):
        root = trace.RECORDING and trace.entry()
        try:
            chk = root and trace.begin()
            if batch and img.ndim != 3:
                raise ValueError(f"{'batch_packed' if packed else 'batch'} "
                                 f"expects (B, H, W)")
            self._validate(img[0] if batch else img, min_val, max_val,
                           self._wide)
            img = self._input(img)
            bounds = _truncated(min_val, max_val)
            if chk:
                trace.end("entry.check", chk)
            if packed or self.backend == "fused":
                # a truncated threshold is its own bound
                return _fused(img, self.taps, bounds,
                              _strict(self.hysteresis_mode), packed)
            fn = canny_fn_batched if batch else canny_fn
            return fn(img, *bounds, kernel_vals=self.taps,
                      backend=self.backend,
                      hysteresis_mode=self.hysteresis_mode)
        finally:
            if root:
                trace.end_entry(root)

    def __call__(self, img, min_val: int, max_val: int):
        """(H, W) -> (H, W) int16 {0, 255} (:func:`canny_fn`)."""
        return self._request(img, min_val, max_val, packed=False, batch=False)

    def packed(self, img, min_val: int, max_val: int):
        """Edge bitmask (H, ceil(W/32)) uint32 (:func:`canny_fn_packed`)."""
        return self._request(img, min_val, max_val, packed=True, batch=False)

    def batch(self, imgs, min_val: int, max_val: int):
        """(B, H, W) -> (B, H, W) int16 {0, 255} (:func:`canny_fn_batched`)."""
        return self._request(imgs, min_val, max_val, packed=False, batch=True)

    def batch_packed(self, imgs, min_val: int, max_val: int):
        """(B, H, W) -> (B, H, ceil(W/32)) uint32 edge bitmasks."""
        return self._request(imgs, min_val, max_val, packed=True, batch=True)

    def with_intermediates(self, img, min_val: int, max_val: int):
        """The stage path on ``device`` with its intermediates: see
        :func:`canny_with_intermediates`."""
        self._validate(img, min_val, max_val)
        return canny_with_intermediates(
            self._input(img), *_truncated(min_val, max_val),
            kernel_vals=self.kernel,
            hysteresis_steps=self.hysteresis_steps)

    @staticmethod
    def _validate(img, min_val, max_val, wide: bool = False):
        # the messages, types and order of CannyTPU._validate
        # (src/main.cpp:63-76); with ``wide`` a uint16 frame too, its
        # thresholds in [0, 65535], and elsewhere a uint16 frame's TypeError
        # names the backend that takes it
        wide = wide and img.dtype in U16
        top = 65535 if wide else 255
        if max_val <= min_val:
            raise ValueError("minVal must be less than maxVal")
        if not (0 <= min_val <= top):
            raise ValueError(f"minVal must be in the range of [0,{top}]")
        if not (0 <= max_val <= top):
            raise ValueError(f"maxVal must be in the range of [0,{top}]")
        if not wide and img.dtype not in U8:
            raise TypeError("input image must be uint8 grayscale" + (
                f"; {WIDE_TAKEN}" if img.dtype in U16 else ""))
