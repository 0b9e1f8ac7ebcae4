"""Sampling the window's answers and judging them (``correct``).

Answers are sampled by a reservoir drawn from the seed: every request of the
window has the same chance to be kept, whatever their number, and only the
kept outputs stay alive.  Once the window has closed, the sampled outputs
go to the host and each is compared pixel by pixel with the frozen oracle
on its frame (``reference/compare.py``).  Each compared number has a limit:

* ``mismatched_px`` (at most 0): pixels, over every sampled output, that
  differ from the oracle; the comparison is exact;
* ``frames_checked`` (at least the sample's size, or every output where
  the window completed fewer): outputs compared.
"""

from __future__ import annotations

import random
import sys


class Reservoir:
    """A uniform sample of ``k`` of the requests offered (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"portbench-sample-{seed}")
        self.items: list = []
        self.seen = 0

    def slot(self) -> int | None:
        """The slot the next request takes (``len(items)`` to append), or
        None when it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            return len(self.items)
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None

    def offer(self, key, value) -> None:
        j = self.slot()
        if j is None:
            return
        if j == len(self.items):
            self.items.append((key, value))
        else:
            self.items[j] = (key, value)


def judge_samples(tasks: list, config: dict, expected: int) -> dict:
    """The run's checks: ``{name: {"value", "limit", "rule"}}``.

    ``tasks``: ``(frame, [outputs])`` by frame of the pool.  ``expected``:
    the outputs that a sound run compares at least."""
    from portbench.reference.compare import judge_all

    res = judge_all([(frame, config["sigma"], config["min_val"],
                      config["max_val"], config["hysteresis_mode"], outs)
                     for frame, outs in tasks])
    flat = [r for per in res for r in per]
    bad = sum(n for n, _ in flat)
    first = next((p for n, p in flat if n), None)
    if first is not None:
        print(f"first differing pixel of a sampled output: {first}",
              file=sys.stderr)
    return {
        "mismatched_px": {"value": bad, "limit": 0, "rule": "<="},
        "frames_checked": {"value": len(flat), "limit": expected,
                           "rule": ">="},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def check_lines(checks: dict) -> list[str]:
    """One line a compared number: its name, value, rule and limit."""
    return [f"check {k}: {c['value']} (limit {c['rule']} {c['limit']})"
            for k, c in checks.items()]
