"""The statistics of the window: a rate over all the work and all the
time, a median, and the union and gaps of intervals."""
from __future__ import annotations

import statistics


def rate(amount: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("an empty window")
    return amount / seconds


def median(values) -> float:
    return statistics.median(values)


def union_length(intervals) -> float:
    """The length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of the time in [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
