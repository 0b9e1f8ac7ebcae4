"""Streaming executor: batches staged onto the card ahead of compute, results
read back behind it, and a cursor for resume (``canny_edge_tpu/parallel/
streaming.py``).

* :class:`DevicePrefetcher`: a thread stages the next host batches onto the
  device ``depth`` batches ahead of the consumer.
* :class:`StreamCursor`: the last completed batch, written atomically, for a
  deterministic restart.
* :class:`StreamingRunner`: frames -> this host's share (round-robin by
  ``host_id`` / ``num_hosts``) -> batches padded to full size -> prefetch ->
  ``run_batch`` -> results trimmed of the padding -> ``on_result``, with
  throughput counters.

On the card a batch is copied from pinned host memory on a stream of its
own (:func:`cuda_put`), and the consumer's stream waits for that copy's
event before anything reads the batch; a result is read back on another
stream after an event recorded behind its compute, so batch N is read back
while batch N + 1 runs.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..io.video import batched
from ..kernels.fused import resolve_device


class StreamCursor:
    """Durable "last completed batch" marker for deterministic restart."""

    def __init__(self, path: str | None):
        self.path = path
        self.completed = -1
        if path and os.path.exists(path):
            with open(path) as f:
                self.completed = json.load(f).get("completed_batch", -1)

    def advance(self, batch_index: int) -> None:
        self.completed = batch_index
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"completed_batch": batch_index,
                           "ts": time.time()}, f)
            os.replace(tmp, self.path)  # atomic


class StagedBatch:
    """A batch whose copy to the card was queued on a side stream."""

    def __init__(self, tensor: torch.Tensor, copied: torch.cuda.Event):
        self.tensor = tensor
        self.copied = copied

    def ready(self) -> torch.Tensor:
        """The batch, for work queued next on the current stream: that
        stream waits for the copy, and the allocator keeps the memory until
        that stream's work is done."""
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.copied)
        self.tensor.record_stream(stream)
        return self.tensor


def cuda_put(device: torch.device) -> Callable:
    """A ``device_put`` for the card: pinned host copy, then an asynchronous
    copy on a stream of its own, returned as a :class:`StagedBatch`."""
    stream = torch.cuda.Stream(device)

    def put(batch: np.ndarray) -> StagedBatch:
        host = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
        with torch.cuda.stream(stream):
            tensor = host.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        return StagedBatch(tensor, copied)

    return put


def default_put(device: torch.device) -> Callable:
    """NumPy batch -> tensor on ``device`` (staged on the card)."""
    if device.type == "cuda":
        return cuda_put(device)
    return lambda batch: torch.from_numpy(np.ascontiguousarray(batch))


class DevicePrefetcher:
    """Stage host batches onto the device ``depth`` ahead of the consumer.

    An exception in the producer is raised in the consumer.
    """

    _END = object()

    def __init__(self, batches: Iterable, put: Callable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._put = put
        self._err: Exception | None = None
        self._thread = threading.Thread(
            target=self._producer, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _producer(self, it: Iterator):
        try:
            for batch in it:
                self._q.put(self._put(batch))
        except Exception as e:  # raised on the consumer side
            self._err = e
        finally:
            self._q.put(self._END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err:
                    raise self._err
                return
            yield item


@dataclass
class StreamStats:
    frames: int = 0
    batches: int = 0
    seconds: float = 0.0
    skipped_batches: int = 0
    mp: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    @property
    def mp_per_s(self) -> float:
        return self.mp / self.seconds if self.seconds else 0.0

    def to_dict(self) -> dict:
        return {"frames": self.frames, "batches": self.batches,
                "seconds": round(self.seconds, 4),
                "skipped_batches": self.skipped_batches,
                "fps": round(self.fps, 2), "mp_per_s": round(self.mp_per_s, 2)}


class StreamingRunner:
    """Run a batch pipeline over a frame stream with prefetch and resume.

    ``run_batch(device_batch) -> result`` is any batch callable (e.g.
    ``lambda b: model.batch(b, mn, mx)``); ``on_result(batch_index,
    np_result)`` consumes the results, trimmed of padding (may be None).
    ``device``: where the default ``device_put`` stages a batch ("cuda",
    which raises without a card, or "cpu"); a ``device_put`` of one's own
    replaces it.
    """

    def __init__(self, run_batch: Callable, *, batch_size: int,
                 prefetch_depth: int = 2, cursor: StreamCursor | None = None,
                 device_put: Callable | None = None,
                 host_id: int = 0, num_hosts: int = 1, device="cuda"):
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.prefetch_depth = prefetch_depth
        self.cursor = cursor or StreamCursor(None)
        self.device = resolve_device(device)
        self.device_put = device_put or default_put(self.device)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._readback = None

    def _host_shard(self, frames: Iterable[np.ndarray]):
        """Round-robin frame sharding across hosts."""
        for i, f in enumerate(frames):
            if i % self.num_hosts == self.host_id:
                yield f

    def run(self, frames: Iterable[np.ndarray],
            on_result: Callable | None = None) -> StreamStats:
        stats = StreamStats()
        start_after = self.cursor.completed

        def indexed_batches():
            for bi, b in enumerate(batched(self._host_shard(frames),
                                           self.batch_size)):
                if bi <= start_after:       # resume: skip completed work
                    stats.skipped_batches += 1
                    continue
                real = b.shape[0]
                if real < self.batch_size:  # pad to the one batch shape
                    pad = np.zeros((self.batch_size - real,) + b.shape[1:],
                                   b.dtype)
                    b = np.concatenate([b, pad])
                yield bi, real, b

        def put(item):
            bi, real, b = item
            return bi, real, b.shape, self.device_put(b)

        t0 = time.perf_counter()
        pending = None
        for bi, real, shape, staged in DevicePrefetcher(
                indexed_batches(), put, self.prefetch_depth):
            if isinstance(staged, StagedBatch):
                staged = staged.ready()
            result = self.run_batch(staged)
            done = None
            if isinstance(result, torch.Tensor) and result.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(result.device))
            if pending is not None:
                # read the last batch back while this one computes
                self._finalize(pending, on_result, stats)
            pending = (bi, real, shape, result, done)
        if pending is not None:
            self._finalize(pending, on_result, stats)
        stats.seconds = time.perf_counter() - t0
        return stats

    def _to_host(self, result, done) -> np.ndarray:
        """A result as a NumPy array; a card tensor is copied on a stream of
        its own once ``done`` (recorded behind its compute) has passed."""
        if done is None:
            return (result.numpy() if isinstance(result, torch.Tensor)
                    else np.asarray(result))
        if self._readback is None:
            self._readback = torch.cuda.Stream(result.device)
        host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
        with torch.cuda.stream(self._readback):
            self._readback.wait_event(done)
            host.copy_(result, non_blocking=True)
            result.record_stream(self._readback)
        self._readback.synchronize()
        return host.numpy()

    def _finalize(self, pending, on_result, stats: StreamStats):
        bi, real, shape, result, done = pending
        host = self._to_host(result, done)[:real]   # trim the padding
        if on_result is not None:
            on_result(bi, host)
        stats.batches += 1
        stats.frames += real                        # real frames only
        stats.mp += float(real * np.prod(shape[1:])) / 1e6
        self.cursor.advance(bi)
