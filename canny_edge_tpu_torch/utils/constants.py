"""One source for the port's tuned knobs and the card's geometry
(``canny_edge_tpu/utils/constants.py``).

Knobs.  The Python modules import them from here.  Where a kernel holds the
same number as a CUDA ``constexpr``, the value here is its mirror, and a CPU
test (``tests/test_torch_bench.py``) reads the CUDA source and holds the two
equal; a retune edits both.

Geometry.  Read from the card (``torch.cuda.get_device_properties``), never
assumed: each function takes a CUDA device and raises without one.  They
stand for the JAX package's TPU-VMEM lookups (``vmem_bytes``,
``frontend_vmem_budget``, ``kernel_vmem_limit``): the kernels here size
their shared memory and grids on the card itself (``csrc/masks.cuh:
coop_blocks``, ``canny_frontend_max_window``), so these say what the card
offers, for the bench's record.

``INNER_DILATE_VMEM`` and ``FLOOD_LIVE_WORD_ARRAYS`` of the JAX package have
no counterpart.  They sized the TPU flood that held the whole packed image
in VMEM and ran rounds of 19 dilations.  K2 replaced it with a schedule of
8-row x 32-word tiles, each flooded to its own fixed point in one warp's
registers, stepping until no tile is dirty
(``kernels/csrc/hysteresis_packed.cu:19-45``; its plain mirror is
``ops/packed_tiles.py``): there are no rounds to size and no image-wide
working set to fit.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# tuned knobs
# ---------------------------------------------------------------------------

# Dilations a round of the plain packed flood (ops/packed.py) and of the
# multi-device path's plain flood (parallel/sharded.py): it changes the
# number of rounds, never the result.
INNER_DILATE_XLA = 4

# K1's output tile, rows x columns a block (csrc/frontend.cu:72-73,
# TILE_H x TILE_W).
K1_TILE = (64, 64)

# K2's tile, rows x words, one warp's registers (csrc/masks.cuh:222
# TILE_ROWS, csrc/hysteresis_packed.cu:81 TILE_WORDS); the tile of its plain
# mirror (ops/packed_tiles.py).
K2_TILE = (8, 32)

# K3's default tile, rows x columns.  No constexpr holds it: the tile is an
# argument of the launch.  The kernel's block (csrc/hysteresis_dilate.cu:77,
# 18 warps) is sized so that the window of this tile, (128 + 2) rows x
# ceil((512 + 2) / 32) words, cut into K2_TILE sub-tiles (17), is one
# sub-tile a warp.
K3_TILE = (128, 512)


# ---------------------------------------------------------------------------
# the card's geometry
# ---------------------------------------------------------------------------

def _props(device):
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the card's geometry needs a CUDA device, got "
                         f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no card to read")
    return torch.cuda.get_device_properties(device)


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device``."""
    return int(_props(device).multi_processor_count)


def smem_optin_bytes(device) -> int:
    """Shared memory one block may opt in to on the CUDA ``device``."""
    return int(_props(device).shared_memory_per_block_optin)


def l2_bytes(device) -> int:
    """L2 cache size of the CUDA ``device``."""
    return int(_props(device).L2_cache_size)


def geometry(device) -> dict:
    """``{"sm_count", "smem_optin_bytes", "l2_bytes"}`` of the CUDA
    ``device``."""
    return {"sm_count": sm_count(device),
            "smem_optin_bytes": smem_optin_bytes(device),
            "l2_bytes": l2_bytes(device)}
