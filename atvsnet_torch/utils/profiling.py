"""Tracing and stage timers (atvsnet_tpu/utils/profiling.py).

device_trace records torch.profiler traces on demand, where the JAX package records
jax.profiler's; StageTimer is the same wall-clock timer, which also records every stage
as a span.

TRACER is the program's one span recorder. `TRACER.span(name)` records a span only while a
torch.profiler session is recording, so tracing is on exactly when a profiler is; with none
it returns one shared null context (or, given `into`, a plain timer of the site's own
always-on clock). A span holds its name, its start and end on time.time_ns() (the clock the
profiler converts its CUDA activity to, so a device gap can be put down to the program span
open at that time), the index of its parent, and a request id that it shares with every
span under the same root. With a CUDA `device` it also records a pair of CUDA events on the
current stream, resolved only when read (Span.device_ms). Spans are kept in memory, at most
MAX_SPANS of them (the rest are counted in `dropped`); device_trace writes a session's to
<logdir>/spans.jsonl. Spans are not torch.profiler.record_function ranges: those can appear
as device-side annotations in the profiler's CUDA activity, and the device trace holds the
same operations with spans as without. `TRACER.count(name, n)` adds n to the counter `name`
in `TRACER.counters`, also only while a session records.

A CUDA graph runs its forward without the host code that records these. `TRACER.template()`
records a capture as though a session recorded, into a Template of its own: its spans' CUDA
events are external ones, which the capture turns into nodes of the graph, so every replay
records them again. After a replay has completed, `TRACER.replay` adds the template's spans
under the replay's parent span, each with the device ms its events read then.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

MAX_SPANS = 1 << 20
_NULL = contextlib.nullcontext()
_templates = 0      # StageTimer.template blocks open: they record as a session would

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _session() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:  # pragma: no cover - older torch without the Python-side flag
    _session = torch._C._autograd._profiler_enabled


def recording() -> bool:
    """Whether a torch.profiler session is recording, or a template (StageTimer.template)."""
    return _session() or _templates > 0


class Span:
    """One recorded interval. parent is the index of the enclosing span in the recorder's
    list (None for a root or a dropped parent); events the (start, end) CUDA events of a
    stage run with a CUDA device, else None; ms the device milliseconds of a span read off
    a graph's replay (StageTimer.replay), which has no events of its own."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "events", "index", "ms")

    def __init__(self, name, start_ns, parent, request, events, index, ms=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.request, self.events, self.index = parent, request, events, index
        self.ms = ms

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's events, once the end event has completed;
        the given ms without events; else None. It never waits for the device."""
        if self.events is None:
            return self.ms
        if not self.events[1].query():
            return None
        return self.events[0].elapsed_time(self.events[1])


class Template:
    """What one captured forward recorded (StageTimer.template): its spans, in order, with
    parents indexing this list (None: the capture's root), and its counters."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: Dict[str, int] = {}


class _Clock:
    """Adds the seconds of a block to into[key]: a site's always-on clock, tracing off."""

    __slots__ = ("into", "key", "t0")

    def __init__(self, into, key):
        self.into, self.key = into, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self.into[self.key] += time.perf_counter() - self.t0
        return False


class _Stage:
    """The context of one recorded stage; closing it twice closes it once."""

    __slots__ = ("timer", "name", "device", "request", "into", "key", "chain", "span")

    def __init__(self, timer, name, device, request, into, key, chain=True):
        self.timer, self.name, self.device, self.request = timer, name, device, request
        self.into, self.key, self.chain, self.span = into, key, chain, None

    def __enter__(self) -> Span:
        self.span = self.timer._open(self.name, self.device, self.request, self.chain)
        return self.span

    def __exit__(self, *exc):
        span, self.span = self.span, None
        if span is not None:
            seconds = self.timer._close(span, self.device, self.chain)
            if self.into is not None:
                self.into[self.key] += seconds
        return False


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A torch.profiler trace of the block when logdir is given, nothing otherwise.

    It records CPU activity, and CUDA activity where CUDA is available, and writes one
    Chrome-trace JSON under logdir (torch.profiler.tensorboard_trace_handler's
    <worker>.<time>.pt.trace.json, which TensorBoard's profiler plugin also reads), and the
    program's spans of the session to <logdir>/spans.jsonl (StageTimer.export).
    """
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = len(TRACER.spans)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    TRACER.export(os.path.join(logdir, "spans.jsonl"), first)


class StageTimer:
    """Accumulating wall-clock stage timer with JSON export, and a span recorder.

    Each `stage(name)` adds its seconds to the stage's total and records a Span. A stage
    given a CUDA `device` also records CUDA events around its work, so Span.device_ms is
    the device's time, where the host clock times only the launches: the device's clock
    from the start event to the end event, idle time within included. Inside a device
    stage, a device stage that opens right after a sibling device stage closed (nothing
    recorded between them) starts at that sibling's end event: the stages of a sequence
    share their boundaries. A stage opened with chain=False records both of its events and
    lends its end event to no sibling: a short span between which and the next the host
    launches device work of its own (the quantization spans of nn.layers).
    """

    def __init__(self, limit: int = MAX_SPANS):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: list[Span] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.limit = limit
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = itertools.count()
        self._external = False     # inside template(): events a graph capture records

    def stage(self, name: str, device: Optional[torch.device] = None, into=None,
              key: Optional[str] = None, request=None, chain: bool = True) -> _Stage:
        """Time and record the block as the span `name`. device: where the block's work
        runs (CUDA events when it is a CUDA device). into, key: also add the block's
        seconds to into[key]. request: the id of a root span (by default a new one; a child
        takes its parent's). chain: share a boundary event with adjacent sibling stages
        (see the class)."""
        return _Stage(self, name, device, request, into, key, chain)

    def span(self, name: str, device: Optional[torch.device] = None, into=None,
             key: Optional[str] = None, request=None, chain: bool = True):
        """stage() while a torch.profiler session is recording; otherwise the shared null
        context, or, with `into`, a plain timer of into[key]."""
        if not recording():
            return _NULL if into is None else _Clock(into, key)
        return _Stage(self, name, device, request, into, key, chain)

    def count(self, name: str, n: int) -> None:
        """Add n to counters[name] while a torch.profiler session is recording."""
        if recording():
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + n

    def _stack(self) -> list:
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.last = [], None
        return local.stack

    def _event(self) -> torch.cuda.Event:
        """A timing event; inside template() an external one, which a capture records as a
        node of its graph."""
        if self._external:
            return torch.cuda.Event(enable_timing=True, external=True)
        return torch.cuda.Event(enable_timing=True)

    def _open(self, name, device, request, chain=True) -> Span:
        stack = self._stack()
        top = stack[-1] if stack else None
        parent = None if top is None else top.index
        if request is None:
            request = next(self._requests) if top is None else top.request
        events = None
        if device is not None and device.type == "cuda":
            last = self._local.last
            if (chain and last is not None and last.parent == parent and top is not None
                    and top.events is not None):
                start = last.events[1]
            else:
                start = self._event()
                start.record(torch.cuda.current_stream(device))
            events = (start, self._event())
        self._local.last = None
        with self._lock:
            index = len(self.spans) if len(self.spans) < self.limit else None
            span = Span(name, time.time_ns(), parent, request, events, index)
            if index is None:
                self.dropped += 1
            else:
                self.spans.append(span)
        stack.append(span)
        return span

    def _close(self, span: Span, device, chain=True) -> float:
        """Ends the span; returns its seconds."""
        if span.events is not None:
            span.events[1].record(torch.cuda.current_stream(device))
        span.end_ns = time.time_ns()
        stack = self._stack()
        while stack and stack.pop() is not span:
            pass  # a child left open (an exception inside it) closes with its parent
        self._local.last = span if chain and span.events is not None else None
        seconds = (span.end_ns - span.start_ns) / 1e9
        self.totals[span.name] = self.totals.get(span.name, 0.0) + seconds
        self.counts[span.name] = self.counts.get(span.name, 0) + 1
        return seconds

    @contextlib.contextmanager
    def template(self):
        """Record the block, a CUDA graph's capture, as though a session recorded, into a
        fresh Template (yielded) instead of this recorder: spans opened in the block go to
        its list, their CUDA events are external (nodes of the graph being captured), and
        counts go to its counters. The block runs on one thread, with the recorder's spans,
        counters and totals put back as they were when it ends."""
        global _templates
        t, local = Template(), self._local
        self._stack()
        saved = (self.spans, self.counters, self.totals, self.counts, self.dropped,
                 local.stack, local.last)
        self.spans, self.counters, self.totals, self.counts = t.spans, t.counters, {}, {}
        local.stack, local.last = [], None
        self._external = True
        _templates += 1
        try:
            yield t
        finally:
            _templates -= 1
            self._external = False
            (self.spans, self.counters, self.totals, self.counts, self.dropped,
             local.stack, local.last) = saved

    def replay(self, template: Template, parent: Optional[Span], start_ns: int,
               end_ns: int) -> None:
        """Add the spans of one replay of a template's graph: the template's spans in order,
        under `parent` (the span the replay ran in; nothing is added without one, as when no
        session records) and with its request id, on the host interval [start_ns, end_ns]
        of the replay's launch, each with the device ms its events read now. Call it once
        the replay has completed on the device."""
        if parent is None:
            return
        added: list[Optional[int]] = []
        with self._lock:
            for s in template.spans:
                index = len(self.spans) if len(self.spans) < self.limit else None
                up = parent.index if s.parent is None else added[s.parent]
                span = Span(s.name, start_ns, up, parent.request, None, index, s.device_ms())
                span.end_ns = end_ns
                added.append(index)
                if index is None:
                    self.dropped += 1
                else:
                    self.spans.append(span)
                self.totals[s.name] = self.totals.get(s.name, 0.0) + (end_ns - start_ns) / 1e9
                self.counts[s.name] = self.counts.get(s.name, 0) + 1

    def between(self, start_ns: int, end_ns: int) -> list[Span]:
        """The closed spans that lie inside [start_ns, end_ns]."""
        return [s for s in list(self.spans)
                if s.end_ns is not None and start_ns <= s.start_ns and s.end_ns <= end_ns]

    def export(self, path: str, first: int = 0) -> None:
        """Write the closed spans from index `first` on as JSON lines (parent: the line of
        the parent span in this file, or None)."""
        spans = [s for s in self.spans[first:] if s.end_ns is not None]
        if any(s.events is not None for s in spans):
            torch.cuda.synchronize()
        line = {s.index: k for k, s in enumerate(spans)}
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps({"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
                                    "parent": line.get(s.parent), "request": s.request,
                                    "device_ms": s.device_ms()}) + "\n")

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in self.totals.items()
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


TRACER = StageTimer()
