"""The run's own child processes.  A run stops every process it starts and
waits for each before it prints its result; :func:`reap` is the last guard
for a child that some library started and left behind."""

from __future__ import annotations

import os
import signal
import time


def children() -> list[tuple[int, str]]:
    """``(pid, command)`` of every live child of this process (``/proc``),
    none where ``/proc`` is not there."""
    me, found = os.getpid(), []
    try:
        pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
            if int(rest[1]) != me or rest[0] == "Z":
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue
        found.append((pid, cmd.strip()))
    return found


def reap(grace_s: float = 5.0) -> list[tuple[int, str]]:
    """End every live child: SIGTERM, then SIGKILL after ``grace_s``, and
    wait for each.  Returns those it found."""
    found = children()
    for pid, _ in found:
        _signal(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for pid, _ in found:
        while not _ended(pid) and time.monotonic() < deadline:
            time.sleep(0.05)
        if not _ended(pid):
            _signal(pid, signal.SIGKILL)
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
    return found


def _signal(pid: int, sig: int) -> None:
    try:
        os.kill(pid, sig)
    except ProcessLookupError:
        pass


def _ended(pid: int) -> bool:
    """True once ``pid`` has ended (it is reaped here if it has)."""
    try:
        return os.waitpid(pid, os.WNOHANG)[0] != 0
    except ChildProcessError:
        return True
