"""The readers of the program's spans (benchmark/metrics/spans.py and the eight metrics
that use it) on a hand-made run: spans in the program's recorder, CUDA events that stand in
for the card's, device operations and their gaps. Each reads the hand-computed value, and
None where the window holds none of its spans."""

import types

import pytest
import torch

from atvsnet_torch.utils import profiling
from benchmark import harness
from benchmark.metrics.spans import overlap_ns
from benchmark.trace import DeviceTrace

MS = 1_000_000


class Event:
    """A completed CUDA event at `t` ms on the device's clock."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.t - self.t


def _tracer(spans):
    """A recorder holding `spans`: (name, start ms, end ms, parent index, device ms or None)."""
    timer = profiling.StageTimer()
    for k, (name, start, end, parent, device_ms) in enumerate(spans):
        events = None if device_ms is None else (Event(0.0), Event(device_ms))
        span = profiling.Span(name, start * MS, parent, 0, events, k)
        span.end_ns = end * MS
        timer.spans.append(span)
    return timer


def _run(events, maps, t0=0, t1=100):
    trace = DeviceTrace()
    trace.events = [(n, s * MS, e * MS) for n, s, e in events]
    trace.t0, trace.t1 = t0 * MS, t1 * MS
    return types.SimpleNamespace(trace=trace, maps_traced=maps, device=torch.device("cpu"),
                                 counters={}, window_s=(t1 - t0) / 1e3)


# two forwards of one map each, with a span outside the window that no reader may count
FORWARDS = [
    ("forward", 10, 40, None, 30.0),
    ("forward.fem", 11, 15, 0, 7.0), ("forward.pairs", 15, 25, 1, 12.0),
    ("forward.aam1", 25, 27, 0, 1.0), ("forward.refine", 27, 35, 0, 6.0),
    ("forward.aam2", 35, 39, 0, 3.0),
    ("forward", 50, 80, None, 28.0),
    ("forward.fem", 51, 55, 6, 6.0), ("forward.pairs", 55, 65, 6, 11.0),
    ("forward.aam1", 65, 67, 6, 1.0), ("forward.refine", 67, 75, 6, 5.0),
    ("forward.aam2", 75, 79, 6, 4.0),
    ("forward.fem", 120, 130, None, 99.0),
    ("eval.startup", 0, 8, None, None), ("eval.load_model", 1, 3, 13, None),
    ("eval.startup", 82, 86, None, None),
]
# operations at 0-12, 14-30, 45-52 and 60-95: the gaps are 12-14, 30-45, 52-60, 95-100;
# inside the forwards' host intervals (10-40, 50-80): 2 + 10 + 8 = 20 ms of 100
EVENTS = [("k", 0, 12), ("k", 14, 30), ("k", 45, 52), ("k", 60, 95)]


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "TRACER", _tracer(FORWARDS))


@pytest.mark.parametrize("kind", ["batch", "served"])
@pytest.mark.parametrize("stage,ms", [("fem", 6.5), ("pairs", 11.5), ("refine", 5.5)])
def test_stage_readers(recorded, kind, stage, ms):
    assert harness.reader(f"stages.{stage}_ms_per_map.{kind}")(_run(EVENTS, 2)) == \
        pytest.approx(ms)


def test_startup_and_launch_idle(recorded):
    run = _run(EVENTS, 2)
    assert harness.reader("driver.startup_ms_per_scene")(run) == pytest.approx(6.0)
    assert harness.reader("serving.launch_idle_share")(run) == pytest.approx(20.0)


NAMES = ["stages.fem_ms_per_map.batch", "stages.pairs_ms_per_map.batch",
         "stages.refine_ms_per_map.batch", "stages.fem_ms_per_map.served",
         "stages.pairs_ms_per_map.served", "stages.refine_ms_per_map.served",
         "driver.startup_ms_per_scene", "serving.launch_idle_share"]


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(monkeypatch, name):
    read = harness.reader(name)
    monkeypatch.setattr(profiling, "TRACER", _tracer([]))
    assert read(_run(EVENTS, 2)) is None
    # spans only outside the window, as with --control, whose forward is not the program's
    monkeypatch.setattr(profiling, "TRACER", _tracer([("eval.startup", 200, 210, None, None),
                                                      ("forward", 200, 210, None, 5.0)]))
    assert read(_run(EVENTS, 2)) is None
    # a program without the recorder (the parent of this change)
    monkeypatch.delattr(profiling, "TRACER")
    assert read(_run(EVENTS, 2)) is None
    # no traced window
    assert read(types.SimpleNamespace(trace=None, maps_traced=0)) is None


def test_stage_reader_needs_every_forwards_device_time(monkeypatch):
    # on the CPU a stage has no events: no device time, no reading
    monkeypatch.setattr(profiling, "TRACER", _tracer([("forward.fem", 11, 15, None, 7.0),
                                                      ("forward.fem", 51, 55, None, None)]))
    assert harness.reader("stages.fem_ms_per_map.batch")(_run(EVENTS, 2)) is None


def test_overlap():
    assert overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert overlap_ns([(0, 100)], [(1, 2), (3, 5), (90, 200)]) == 1 + 2 + 10
    assert overlap_ns([], [(0, 1)]) == 0
