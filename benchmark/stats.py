"""The arithmetic of the benchmark's metrics, on plain numbers."""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``: the
    smallest value with at least ``q`` % of them at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[list] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out


def idle_pct(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """The share of ``[lo, hi]`` in which no interval runs, in %."""
    return 100.0 * (1.0 - busy(intervals, lo, hi) / (hi - lo))
