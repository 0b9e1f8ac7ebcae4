"""Native (C++) runtime of the port, loaded with ``ctypes``: the counterpart
of ``canny_edge_tpu/runtime``.

:class:`FrameFeeder` is a producer thread with a ring buffer of frames
(synthetic, ``raw8`` files, or a directory of ``frame_%06d.pgm``), the
datacenter replacement for the reference's blocking webcam loop
(src/main.cpp:78-115); :func:`minmax_normalize_u8_native` is the ``-s``
view's normalization.  ``csrc/feeder.cpp`` is built with ``g++`` at first
use into ``canny_edge_tpu_torch/kernels/build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags; it is written to a temporary
file and renamed into place, so processes building at once never load a
half-written library.  Nothing is built when the module is imported.
Without a compiler :func:`available` is False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

SOURCE = Path(__file__).parent / "csrc" / "feeder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared"]

MODE_SYNTHETIC = 0
MODE_RAW8 = 1
MODE_PGM_DIR = 2

_lock = threading.Lock()
_state: dict = {"lib": None, "error": None}


def lib_path() -> Path:
    """Where the library of ``csrc/feeder.cpp`` as it stands now is built."""
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcanny_feeder_{tag}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.

    Raises ``RuntimeError`` with the compiler's output if the build fails,
    or if there is no ``g++`` (or ``$CXX``).
    """
    dst = lib_path()
    if dst.exists():
        return dst
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native feeder needs a C++ compiler (g++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{cxx} failed for feeder.cpp:\n{r.stdout}"
                               f"{r.stderr}")
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dst


def _load():
    """The loaded library, built on first use; None (and the reason kept)
    where it cannot be built or loaded."""
    with _lock:
        if _state["lib"] is not None or _state["error"] is not None:
            return _state["lib"]
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _state["error"] = str(e)
            return None
        lib.feeder_create.restype = ctypes.c_void_p
        lib.feeder_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.feeder_acquire.restype = ctypes.c_int64
        lib.feeder_acquire.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int]
        lib.feeder_release.restype = None
        lib.feeder_release.argtypes = [ctypes.c_void_p]
        lib.feeder_stats.restype = None
        lib.feeder_stats.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint64)] * 5
        lib.feeder_destroy.restype = None
        lib.feeder_destroy.argtypes = [ctypes.c_void_p]
        lib.minmax_normalize_u8.restype = None
        lib.minmax_normalize_u8.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads (it is built on the first call)."""
    return _load() is not None


class FrameFeeder:
    """Background-thread frame producer with a zero-copy ring buffer.

    Example::

        with FrameFeeder(1080, 1920, count=1000) as feeder:
            for frame in feeder:          # np.uint8 (H, W) views
                edges = model(frame, 50, 150)
    """

    def __init__(self, h: int, w: int, *, capacity: int = 8,
                 mode: int = MODE_SYNTHETIC, path: str = "",
                 count: int = 0, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native feeder library unavailable: "
                               f"{_state['error']}")
        self._lib = lib
        self.h, self.w = h, w
        self._handle = lib.feeder_create(
            h, w, capacity, mode, path.encode(), count, seed)
        if not self._handle:
            raise RuntimeError("feeder_create failed (bad args or source)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.next(timeout_ms=-1)
            if frame is None:
                return
            yield frame

    def next(self, timeout_ms: int = -1):
        """Acquire the next frame as a zero-copy view; None at the end of the
        stream.  The view is valid until the next call (which releases its
        slot): copy it to keep it longer."""
        self._lib.feeder_release(self._handle)
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        idx = self._lib.feeder_acquire(self._handle, ctypes.byref(ptr),
                                       timeout_ms)
        if idx == -1:
            return None
        if idx == -2:
            raise TimeoutError("feeder_acquire timed out")
        return np.ctypeslib.as_array(ptr, shape=(self.h, self.w))

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(5)]
        self._lib.feeder_stats(self._handle, *[ctypes.byref(v) for v in vals])
        keys = ("produced", "consumed", "producer_waits", "consumer_waits",
                "read_errors")
        return dict(zip(keys, (v.value for v in vals)))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.feeder_destroy(self._handle)
            self._handle = None


def minmax_normalize_u8_native(img: np.ndarray) -> np.ndarray:
    """Native min-max normalize, bit-identical to
    :func:`..io.imageio.minmax_normalize_u8`, which it falls back to where
    the library is unavailable."""
    lib = _load()
    if lib is None:
        from ..io.imageio import minmax_normalize_u8

        return minmax_normalize_u8(img)
    src = np.ascontiguousarray(img, np.int16)
    dst = np.empty(src.shape, np.uint8)
    lib.minmax_normalize_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.size)
    return dst
