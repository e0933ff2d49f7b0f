"""The program's own spans in a traced run's host ranges.

The port marks its layers with ``torch.profiler`` ranges named
``emodis.*`` while a profiler records.  In a program without them a name
finds no range and its time is 0; the metric that reads it then returns
``None`` and is left out of the result line.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.trace import _union


def intervals(reading, name: str) -> List[Tuple[float, float]]:
    """The union of the host ranges named ``name`` (microseconds)."""
    return _union([(a, b) for a, b, n, _ in reading.host if n == name])


def seconds(reading, name: str) -> float:
    """The host time inside ranges named ``name``, overlaps counted once."""
    return sum(b - a for a, b in intervals(reading, name)) / 1e6


def overlap_seconds(reading, inner: str, outer: str) -> float:
    """The host time inside both a range named ``inner`` and one named
    ``outer``."""
    xs, ys = intervals(reading, inner), intervals(reading, outer)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6
