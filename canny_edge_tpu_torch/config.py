"""One dataclass for every run-time knob of the command line: the port's own
copy of ``canny_edge_tpu/config.py:CannyConfig``, with the same fields,
messages and backend names.

It replaces the reference's compile-time constants and positional argv
(#define WIDTH/HEIGHT src/main.cpp:12-13, NUM_BLOCKS/BLOCK_SIZE
src/cuda.cu:9-10, ENABLE_CUDA CMakeLists.txt:4-8), validated as the
reference's CLI validates (src/main.cpp:63-76).  The port runs no
``sharded`` backend and no mesh yet: the command line refuses them.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

BACKENDS = ("fused", "xla", "pallas", "sharded", "golden")


@dataclass(frozen=True)
class CannyConfig:
    # algorithm (reference positional args, src/main.cpp:58-60)
    sigma: float = 1.0
    min_val: int = 50
    max_val: int = 150

    # execution
    backend: str = "fused"            # fused | xla | pallas | sharded | golden
    hysteresis_mode: str = "component"  # component | strict-reference

    # batching / sharding
    batch_size: int = 1
    mesh_data: int = 1
    mesh_y: int = 1
    mesh_x: int = 1

    # streaming
    prefetch_depth: int = 2
    checkpoint_path: str | None = None  # stream cursor file for resume
    packed_transfer: bool = False       # device returns bit-packed masks

    def __post_init__(self):
        if self.max_val <= self.min_val:
            raise ValueError("minVal must be less than maxVal")
        if not (0 <= self.min_val <= 255):
            raise ValueError("minVal must be in the range of [0,255]")
        if not (0 <= self.max_val <= 255):
            raise ValueError("maxVal must be in the range of [0,255]")
        if self.sigma <= 0:
            raise ValueError("sigma must be positive")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend: {self.backend}")
        if self.hysteresis_mode not in ("component", "strict-reference"):
            raise ValueError(
                f"unknown hysteresis mode: {self.hysteresis_mode}")
        if self.batch_size < 1:
            raise ValueError("batch size must be >= 1")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch depth must be >= 1")

    def to_dict(self) -> dict:
        return asdict(self)
