"""The multi-device path (halo exchange, the sharded model, several
processes) and the streaming of frames, with the names
``canny_edge_tpu.parallel`` exports."""

from .halo import (  # noqa: F401
    halo_exchange_2d,
    halo_exchange_cols,
    halo_exchange_rows,
)
from .sharded import (  # noqa: F401
    DATA_AXIS,
    X_AXIS,
    Y_AXIS,
    ShardedBatch,
    ShardedCanny,
    make_mesh,
)
from .streaming import (  # noqa: F401
    DevicePrefetcher,
    StreamCursor,
    StreamingRunner,
    StreamStats,
)
