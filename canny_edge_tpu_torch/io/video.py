"""Frame sources for batch and stream processing: the port's own copy of
``canny_edge_tpu/io/video.py``.

An image, a directory of images, a video file or camera index (OpenCV only),
or ``synthetic:HxW[xN]``; each yields uint8 grayscale frames.  The native
feeder (:mod:`..runtime`) gives a producer thread behind the same iterator
interface.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

from . import imageio
from .imageio import bgr_to_gray, load_grayscale, synthetic_image

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".ppm", ".tif",
              ".tiff", ".webp"}


def frames_from_video(path: str, max_frames: int | None = None,
                      grayscale: bool = True) -> Iterator[np.ndarray]:
    """Decode frames from a video file (or camera index) with OpenCV.

    The capture is opened here, so that a bad source raises at once.
    Without OpenCV this raises ``ValueError``.
    """
    cv2 = imageio.cv2
    if cv2 is None:
        raise ValueError(f"cannot read video {path}: it needs OpenCV (cv2), "
                         "which is not installed")
    cap = cv2.VideoCapture(int(path) if str(path).isdigit() else path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video source: {path}")
    return _video_frames(cap, max_frames, grayscale)


def _video_frames(cap, max_frames, grayscale) -> Iterator[np.ndarray]:
    try:
        n = 0
        while max_frames is None or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if grayscale and frame.ndim == 3:
                frame = bgr_to_gray(frame)
            yield frame.astype(np.uint8)
            n += 1
    finally:
        cap.release()


def _image_names(path: str) -> list:
    return sorted(f for f in os.listdir(path)
                  if os.path.splitext(f)[1].lower() in IMAGE_EXTS)


def frames_from_dir(path: str) -> Iterator[np.ndarray]:
    names = _image_names(path)
    if not names:
        raise FileNotFoundError(f"no images in directory: {path}")
    for name in names:
        yield load_grayscale(os.path.join(path, name))


def frames_synthetic(h: int, w: int, count: int,
                     seed: int = 0) -> Iterator[np.ndarray]:
    for i in range(count):
        yield synthetic_image(h, w, seed=seed + i)


def parse_dims(dims: str) -> tuple:
    """``"HxW[xN]"`` -> (H, W, N or None)."""
    d = [int(v) for v in dims.split("x")]
    return d[0], d[1], (d[2] if len(d) > 2 else None)


def open_source(spec: str, max_frames: int | None = None
                ) -> Iterator[np.ndarray]:
    """Open a frame source.

    ``spec`` is an image path, a video path, a directory of images, a camera
    index, or ``synthetic:HxW[xN]`` (e.g. ``synthetic:1080x1920x64``).
    """
    if spec.startswith("synthetic:"):
        h, w, n = parse_dims(spec.split(":", 1)[1])
        n = 1 if n is None else n
        if max_frames is not None:
            n = min(n, max_frames)
        return frames_synthetic(h, w, n)
    if os.path.isdir(spec):
        if not _image_names(spec):        # checked here: the reader is lazy
            raise FileNotFoundError(f"no images in directory: {spec}")
        return _take(frames_from_dir(spec), max_frames)
    ext = os.path.splitext(spec)[1].lower()
    if ext in IMAGE_EXTS:
        return _take(iter([load_grayscale(spec)]), max_frames)
    return frames_from_video(spec, max_frames)


def _take(it: Iterator[np.ndarray], n: int | None) -> Iterator[np.ndarray]:
    if n is None:
        yield from it
        return
    for i, f in enumerate(it):
        if i >= n:
            break
        yield f


def batched(frames: Iterable[np.ndarray], batch_size: int,
            pad_to_full: bool = False) -> Iterator[np.ndarray]:
    """Group frames into (B, H, W) batches (the last may be short, or padded
    with zero frames when ``pad_to_full``)."""
    buf: list[np.ndarray] = []
    for f in frames:
        buf.append(f)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        if pad_to_full:
            buf += [np.zeros_like(buf[0])] * (batch_size - len(buf))
        yield np.stack(buf)
