"""What the readers of the program's own spans share. The program records them in
atvsnet_torch.utils.profiling.TRACER while a profiler session records, so in a traced run
(--trace 1) and in no other. Each reader returns None where the traced window holds none of
the spans it reads: in a program without the recorder, or under --control, whose forward is
not the program's."""

from __future__ import annotations

from benchmark import stats
from benchmark.metrics.common import traced


def window_spans(run):
    """The program's closed spans inside [run.trace.t0, run.trace.t1], or None."""
    if not traced(run):
        return None
    from atvsnet_torch.utils import profiling

    tracer = getattr(profiling, "TRACER", None)
    if tracer is None:
        return None
    return tracer.between(run.trace.t0, run.trace.t1) or None


def stage_ms_per_map(run, name: str):
    """Device milliseconds between the events of every span `name` in the window, summed,
    over the maps traced; None without such spans or without their device time."""
    spans = window_spans(run)
    ms = [s.device_ms() for s in spans or () if s.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / run.maps_traced


def host_ms(run, name: str):
    """Mean host milliseconds of the spans `name` in the window, or None."""
    spans = [s for s in window_spans(run) or () if s.name == name]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(spans)


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint (start, end) intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_share(run, name: str):
    """The device's idle time (the gaps between the trace's operations in the window) that
    falls inside the union of the spans `name`, over the window's length (%); or None."""
    spans = [(s.start_ns, s.end_ns) for s in window_spans(run) or () if s.name == name]
    if not spans:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    idle = stats.gaps([(s, e) for _, s, e in run.trace.events], t0, t1)
    return 100.0 * overlap_ns(idle, stats.union(spans)) / (t1 - t0)
