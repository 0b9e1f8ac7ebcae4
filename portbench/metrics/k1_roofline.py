"""``k1_roofline`` (%, device trace): K1's floor over K1's device time a
request in the traced slice.

K1 is the front end, ``kernels/csrc/frontend.cu``: its kernels are named
``frontend_kernel`` (the tile path), ``frontend_ring_kernel`` (the ring
path) and ``frontend_tail_kernel`` with ``large_*`` (the scratch path).

The floor is frozen here, from the hand model of the work as it stood when
the benchmark was defined (``utils/roofline.py:kernel_bounds``,
``"frontend"``): a frame's bytes, its pixels read once (one byte a uint8
pixel, two a uint16 one) and the two packed uint32 masks (weak, strong)
written once, at the card's HBM rate, against its operations, ``4 * window
+ 45`` a pixel whatever the frame's type (the same work, whatever carries
it), at the card's rate of separate operations (half the float32 rate,
which counts an FMA as two: the blur's exactness forbids fusing a multiply
and an add); the larger binds.
"""

import math
import re

from portbench.harness.spec import frame_itemsize
from portbench.reference.oracle import gaussian_window

# NVIDIA's data sheet, H100 SXM at 700 W: HBM bytes a second, and separate
# (unfused) operations a second, half the 67e12 float32 FMA rate
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                   "ops_per_s": 33.5e12}}
KERNEL = re.compile(r"\b(frontend_kernel|frontend_ring_kernel|"
                    r"frontend_tail_kernel|large_\w+)\b")


def is_k1(name: str) -> bool:
    return KERNEL.search(name) is not None


def ops_per_px(window: int) -> int:
    return 4 * window + 45


def frame_bytes(h: int, w: int, itemsize: int = 1) -> int:
    """The bytes K1 must move for one ``(h, w)`` frame of ``itemsize``-byte
    pixels: the frame read once, two packed masks written once."""
    return h * w * itemsize + 2 * h * math.ceil(w / 32) * 4


def frame_floor_s(h: int, w: int, window: int, device_kind: str,
                  itemsize: int = 1):
    """K1's least time on one ``(h, w)`` frame of ``itemsize``-byte pixels,
    or None for a card not in the table."""
    peaks = PEAKS.get(device_kind)
    if peaks is None:
        return None
    nbytes = frame_bytes(h, w, itemsize)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               h * w * ops_per_px(window) / peaks["ops_per_s"])


def floor_s(run):
    """K1's least time a request of ``run``."""
    c = run.config
    f = frame_floor_s(c["height"], c["width"], gaussian_window(c["sigma"]),
                      run.device_kind, frame_itemsize(c))
    return None if f is None else f * run.frames_per_request


def read(run):
    tr = run.trace
    floor = floor_s(run)
    if tr is None or tr.requests == 0 or floor is None:
        return None
    t = tr.device_s(is_k1) / tr.requests
    return 100.0 * floor / t if t > 0 else None
