"""Scratch of the cooperative hysteresis kernels (K2, K3, K4), kept between
calls.

Each kernel keeps, per device, stream and configuration (the frames B and
the shape ``(H, W)`` of a call, tile or band), its 64-bit control words
(dirty flags, "anything changed" words and the counts a call leaves behind)
and its packed ``(B H, ceil(W/32))`` uint32 buffers.  B is part of the key:
a batch and a frame of the same ``B H W`` pixels never share an entry.  The control words are zeroed once: every launch takes a fresh
token (a sequence number shifted past any step or sweep count), so a flag of
an earlier call never reads as set and nothing is cleared between calls.
Two calls on one stream run in order, so they may share an entry; another
stream gets its own.
"""

from __future__ import annotations

import torch

from ..ops.packed import cdiv

MAX_ENTRIES = 8      # per kernel; the least recently used entry goes first

_sequence = 0


def next_token() -> int:
    """The token of one launch: never reused, by any kernel."""
    global _sequence
    _sequence += 1
    return _sequence << 32


class Scratch:
    """The entries of one kernel: ``{"ctl": int64 tensor, name: buffer}``."""

    def __init__(self):
        self._entries: dict = {}

    def lookup(self, dev, stream, key):
        """The entry of ``(dev, stream, *key)``, or None."""
        key = (dev.index, stream, *key)
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._entries[key] = entry      # most recently used last
        return entry

    def create(self, dev, stream, key, ctl_words: int) -> dict:
        """A new entry of ``(dev, stream, *key)`` with ``ctl_words`` zeroed
        control words; the least recently used one makes room."""
        while len(self._entries) >= MAX_ENTRIES:
            self._entries.pop(next(iter(self._entries)))
        entry = {"ctl": torch.zeros(ctl_words, dtype=torch.int64, device=dev)}
        self._entries[(dev.index, stream, *key)] = entry
        return entry

    def __len__(self):
        return len(self._entries)


def buffer(entry: dict, name: str, h: int, w: int, dev) -> torch.Tensor:
    """The packed ``(h, ceil(w/32))`` uint32 buffer ``name`` of an entry,
    made when first needed; its contents are the kernel's to fill."""
    if name not in entry:
        entry[name] = torch.empty((h, cdiv(w, 32)), dtype=torch.uint32,
                                  device=dev)
    return entry[name]
