"""The device trace of a traced run: every operation the card ran between start() and
stop(), from torch.profiler's CUDA activity (CUPTI), with host spans to say what the host
was doing in the device's idle gaps.

Only CUDA activity is recorded (kernels, copies, sets): no CPU operator events, which
would double a trace of tens of thousands of launches per depth map. The events are read
straight from the profiler's results, not through its per-operator tables, whose sums
over-count the device span. Timestamps are the profiler's, which it converts to the host's
wall clock; host spans are taken with time.time_ns() and so share it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from benchmark import stats

NAME_CHARS = 120


class Spans:
    """Named host intervals, (label, start_ns, end_ns), in the order they closed."""

    def __init__(self):
        self.items = []

    @contextmanager
    def __call__(self, label: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((label, t0, time.time_ns()))

    def total_s(self, label: str) -> float:
        """Seconds of the spans named `label`."""
        return sum(e - s for n, s, e in self.items if n == label) / 1e9

    def count(self, label: str) -> int:
        return sum(1 for n, _, _ in self.items if n == label)

    def at(self, t_ns: int) -> str:
        """The innermost span around a point in time, or 'no span'."""
        inside = [(s, n) for n, s, e in self.items if s <= t_ns <= e]
        return max(inside)[1] if inside else "no span"


class DeviceTrace:
    def __init__(self):
        self.events = []          # (name, start_ns, end_ns) of every device operation
        self.t0 = self.t1 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.t0 = time.time_ns()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self._prof.stop()
        results = self._prof.profiler.kineto_results
        self.events = sorted(
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in results.events() if e.device_type() == torch.autograd.DeviceType.CUDA)
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return stats.covered([(s, e) for _, s, e in self.events]) / 1e9

    def kernel_s(self, match) -> float:
        """Device seconds in which an operation whose name `match` accepts ran: the union of
        their intervals (the card runs some of cuDNN's kernels side by side, so their summed
        durations exceed the time they take)."""
        return stats.covered([(s, e) for n, s, e in self.events if match(n)]) / 1e9

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        by_name = {}
        for n, s, e in self.events:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo = min([self.t0] + [s for _, s, _ in self.events])
        hi = max([self.t1] + [e for _, _, e in self.events])
        holes = stats.gaps([(s, e) for _, s, e in self.events], lo, hi)
        holes = sorted(holes, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[spans.at((s + e) // 2), (e - s) / 1e9] for s, e in holes]}
