"""Tracing and stage timers (atvsnet_tpu/utils/profiling.py).

device_trace records torch.profiler traces on demand, where the JAX package records
jax.profiler's; StageTimer is the same plain wall-clock timer.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A torch.profiler trace of the block when logdir is given, nothing otherwise.

    It records CPU activity, and CUDA activity where CUDA is available, and writes one
    Chrome-trace JSON under logdir (torch.profiler.tensorboard_trace_handler's
    <worker>.<time>.pt.trace.json, which TensorBoard's profiler plugin also reads).
    """
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StageTimer:
    """Accumulating wall-clock stage timer with JSON export.

    CUDA runs asynchronously: end a timed region on a host-visible result (a
    torch.cuda.synchronize() or a .item()), or it times the launches, not the work.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in self.totals.items()
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
