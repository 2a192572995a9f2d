"""The device's busy time: the union of its activity intervals.

Kernels on different streams overlap (the obs prefetch runs on a stream of
its own), so the busy time is the length of the union of their intervals
within the window, each overlap counted once, and not their sum.
"""

from __future__ import annotations


def merged(intervals, lo=float("-inf"), hi=float("inf")):
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def busy(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo, hi):
    """The idle intervals of [lo, hi] between the merged activity."""
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
