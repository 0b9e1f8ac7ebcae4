"""``k2_roofline`` (%, device trace): K2's floor over K2's device time a
request in the traced slice.

K2 is the packed hysteresis flood, ``kernels/csrc/hysteresis_packed.cu``:
its kernel is named ``flood_kernel``.  On the ``fused`` path it reads K1's
two packed masks and writes the int16 edge map.

The floor is frozen here, from the hand model as it stood when the
benchmark was defined (``utils/roofline.py``: ``kernel_bounds``'s
``"hysteresis_packed"`` for packed edges out, ``backend_stages("fused")``'s
hysteresis stage for int16 out): the two uint32 masks read once and the
output written once, at the card's HBM rate, against ~40 operations a
packed word at its rate of separate operations; the larger binds.  It counts
no flood step past the first, so it is a floor whatever the frame.
"""

import math
import re

PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                   "ops_per_s": 33.5e12}}
OPS_PER_WORD = 40
KERNEL = re.compile(r"\bflood_kernel\b")


def is_k2(name: str) -> bool:
    return KERNEL.search(name) is not None


def frame_floor_s(h: int, w: int, device_kind: str, int16_out: bool = True):
    """K2's least time on one ``(h, w)`` frame, or None for a card not in
    the table.  ``int16_out``: the int16 map out (the ``fused`` path), else
    the packed edge words."""
    peaks = PEAKS.get(device_kind)
    if peaks is None:
        return None
    words = h * math.ceil(w / 32)
    nbytes = 2 * words * 4 + (2 * h * w if int16_out else words * 4)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               OPS_PER_WORD * words / peaks["ops_per_s"])


def floor_s(run):
    """K2's least time a request of ``run``."""
    c = run.config
    f = frame_floor_s(c["height"], c["width"],
                      run.device_kind)
    return None if f is None else f * run.frames_per_request


def read(run):
    tr = run.trace
    floor = floor_s(run)
    if tr is None or tr.requests == 0 or floor is None:
        return None
    t = tr.device_s(is_k2) / tr.requests
    return 100.0 * floor / t if t > 0 else None
