"""What a run recorded, as the metric readers see it (``read(run)``).

Times are ``time.perf_counter()`` seconds of the run's process.  A request
is what the driver hands the program at once: a frame or a batch.
``starts[i]`` is when request ``i`` was handed in (its call's start),
``call_ends[i]`` when that call returned, ``dones[i]`` when its completion
was observed.  The window runs from its first hand-in to its last
completion.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Run:
    config: dict
    setup_s: float
    window: tuple[float, float]
    starts: list
    call_ends: list
    dones: list
    frames_per_request: int
    pixels_per_frame: int
    attempted: int
    failed: int = 0
    traced: tuple[int, int] | None = None   # requests [a, b) in the slice
    trace: object | None = None             # harness.trace.Trace
    device_kind: str = ""                   # torch.cuda.get_device_name()

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def completed(self) -> int:
        return len(self.dones)

    @property
    def pixels_done(self) -> int:
        return self.completed * self.frames_per_request * self.pixels_per_frame

    def untraced(self) -> list[int]:
        """Indices of the completed requests outside the traced slice."""
        a, b = self.traced or (0, 0)
        return [i for i in range(self.completed) if not a <= i < b]

    def latencies_s(self) -> np.ndarray:
        n = self.completed
        return np.asarray(self.dones[:n]) - np.asarray(self.starts[:n])


def rate_mpix_per_s(run: Run) -> float | None:
    """All pixels of all completed requests over the window's seconds."""
    if run.completed == 0 or run.window_s <= 0:
        return None
    return run.pixels_done / run.window_s / 1e6
