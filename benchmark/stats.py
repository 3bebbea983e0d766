"""The statistics the benchmark reports: a percentile of all samples, the quartile spread
of repeated runs, and the union of time intervals (a device's busy time)."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of all values, linear between the two closest
    ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles (statistics.quantiles, n=4) as
    a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals covering the same points."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, start, end) -> list:
    """The (start, end) stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
