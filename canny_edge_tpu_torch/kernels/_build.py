"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use.  ``--fmad=false``
keeps nvcc from contracting a multiply and an add into an FMA, which would
change the blur's float32 rounding; ``--use_fast_math`` is never passed.
The libraries go to ``build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded; the hash also covers the shared
headers (``csrc/*.cuh``).  :func:`build_all` compiles every source in
parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# C entry points: name -> (argtypes); every entry returns an int (a
# cudaError_t where it launches, else the value it is named for)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
SIGNATURES = {
    "frontend": {
        "canny_frontend": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
        "canny_frontend_block": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I,
                                 _I, _I, _P, _P, _P, _P],
        "canny_frontend_max_window": [],
    },
    "hysteresis_packed": {
        "canny_hysteresis_packed": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I,
                                    _I, _I, _I, _P, _L, _P],
        "canny_hysteresis_packed_scratch_words": [_I, _I],
    },
    "hysteresis_dilate": {
        "canny_dilate_smem_bytes": [_I, _I],
        "canny_dilate_smem_limit": [],
        "canny_dilate_scratch_words": [_I, _I, _I, _I],
        "canny_dilate": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                         _L, _P],
    },
    "hysteresis_banded": {
        "canny_banded_smem_bytes": [_I, _I],
        "canny_banded_smem_limit": [],
        "canny_banded_max_width": [],
        "canny_banded_scratch_words": [],
        "canny_banded": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _L,
                         _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The toolkit's ``nvcc`` (``cuobjdump`` lies beside it)."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` as it stands now is built."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, float]:
    """Compile the missing libraries, one ``nvcc`` per source, in parallel.

    Returns ``{name: seconds}`` for the ones compiled.  Raises
    ``RuntimeError`` with the compiler's output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst)
    times, errors = {}, []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, dst)
        times[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def device_guard(device):
    """A context in which ``device`` (a CUDA ``torch.device``) is current, as
    a launch needs; it costs nothing when the device is current already."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)     # no Stream object: a tenth of the time
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
