"""Streaming of frames to one device.  The multi-device path (halo
exchange, the sharded model, several hosts) is not ported yet."""

from .streaming import (  # noqa: F401
    DevicePrefetcher,
    StreamCursor,
    StreamingRunner,
    StreamStats,
)
