"""Single-device Canny model on PyTorch: ``CannyTPU``'s three backends and
its ``with_intermediates``.

``backend="fused"`` (default): K1 (front end with the threshold compares and
the 32-to-1 packing) -> K2 (packed hysteresis flood, which also writes the
int16 {0, 255} map).  ``"pallas"``: :func:`..kernels.fused.canny_fused` (K1
in NMS mode, then K2 through its NMS-map entry).  ``"xla"``: the plain front end
and the plain packed flood, no kernel.  The ``packed`` entry points run the
fused engines whatever the backend, as in JAX.  On a CUDA device the stages
are the hand-written kernels; with ``device="cpu"`` the same wrappers run
their plain PyTorch versions.  ``with_intermediates`` runs the unpacked
stage path of :mod:`..ops.stages` in plain PyTorch wherever the model lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.frontend import frontend
from ..kernels.fused import canny_fused, resolve_device
from ..kernels.hysteresis_packed import hysteresis_packed
from ..ops import stages
from ..ops.gaussian import gaussian_kernel
from ..ops.packed import hysteresis_packed as hysteresis_packed_plain
from ..ops.window import frontend_nm

MODES = ("component", "strict-reference")
BACKENDS = ("fused", "pallas", "xla")


def check_uint8(img) -> None:
    """``TypeError`` unless ``img`` (an array or a tensor) is uint8, with
    ``CannyTPU``'s message."""
    if img.dtype not in (np.uint8, torch.uint8):
        raise TypeError("input image must be uint8 grayscale")


def uint8_input(img, device) -> torch.Tensor:
    """A model's uint8 input (an array or a tensor) as a tensor on
    ``device``, after :func:`check_uint8`."""
    check_uint8(img)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return img.to(device)


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
    all three give the same edges.  ``hysteresis_steps``: dilations between
    two convergence tests of ``with_intermediates``, whose count it also
    sets; the backends never read it.  Inputs may be NumPy arrays or
    tensors; outputs are tensors on ``device``.
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
        if hysteresis_mode not in MODES:
            raise ValueError(f"unknown hysteresis mode: {hysteresis_mode!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        kernel = np.asarray(kernel, np.float32)
        if kernel.ndim != 1 or kernel.shape[0] % 2 != 1:
            raise ValueError("kernel must be 1-D with an odd number of taps")
        device = resolve_device(device)
        self.hysteresis_mode = hysteresis_mode
        self.hysteresis_steps = hysteresis_steps
        self.backend = backend
        self.kernel = kernel
        self.device = device
        self.taps = torch.from_numpy(kernel.copy()).to(device)

    @property
    def window(self) -> int:
        return int(self.kernel.shape[0])

    @property
    def strict(self) -> bool:
        return self.hysteresis_mode == "strict-reference"

    def _frame_packed(self, img, min_val, max_val, edges_int16=False):
        h, w = img.shape
        weak, strong = frontend(img, self.taps, (min_val, max_val))
        return hysteresis_packed(weak, strong, h, w, strict=self.strict,
                                 edges_int16=edges_int16)

    def _frame(self, img, min_val, max_val):
        """One uint8 (H, W) frame -> int16 {0, 255} through the backend."""
        if self.backend == "fused":
            return self._frame_packed(img, min_val, max_val, edges_int16=True)
        if self.backend == "pallas":
            return canny_fused(img, min_val, max_val, kernel_vals=self.taps,
                               strict=self.strict)
        return hysteresis_packed_plain(frontend_nm(img, self.kernel), min_val,
                                       max_val, strict=self.strict)

    def _input(self, img):
        return uint8_input(img, self.device)

    def __call__(self, img, min_val: int, max_val: int):
        self._validate(img, min_val, max_val)
        return self._frame(self._input(img), min_val, max_val)

    def packed(self, img, min_val: int, max_val: int):
        """Edge bitmask (H, ceil(W/32)) uint32 (bit b of word j = column 32j+b)."""
        self._validate(img, min_val, max_val)
        return self._frame_packed(self._input(img), min_val, max_val)

    def batch(self, imgs, min_val: int, max_val: int):
        """(B, H, W) -> (B, H, W) int16 {0, 255}, one frame at a time."""
        imgs = self._batch_input(imgs, min_val, max_val)
        return torch.stack([self._frame(f, min_val, max_val) for f in imgs])

    def batch_packed(self, imgs, min_val: int, max_val: int):
        """(B, H, W) -> (B, H, ceil(W/32)) uint32 edge bitmasks."""
        imgs = self._batch_input(imgs, min_val, max_val)
        return torch.stack([self._frame_packed(f, min_val, max_val)
                            for f in imgs])

    def with_intermediates(self, img, min_val: int, max_val: int):
        """The stage path on ``device`` with its intermediates: see
        :func:`canny_with_intermediates`."""
        self._validate(img, min_val, max_val)
        return canny_with_intermediates(
            self._input(img), min_val, max_val, kernel_vals=self.kernel,
            hysteresis_steps=self.hysteresis_steps)

    def _batch_input(self, imgs, min_val, max_val):
        if imgs.ndim != 3:
            raise ValueError("batch expects (B, H, W)")
        self._validate(imgs[0], min_val, max_val)
        return self._input(imgs)

    @staticmethod
    def _validate(img, min_val, max_val):
        # the messages and types of CannyTPU._validate (src/main.cpp:63-76)
        if max_val <= min_val:
            raise ValueError("minVal must be less than maxVal")
        if not (0 <= min_val <= 255):
            raise ValueError("minVal must be in the range of [0,255]")
        if not (0 <= max_val <= 255):
            raise ValueError("maxVal must be in the range of [0,255]")
        check_uint8(img)
