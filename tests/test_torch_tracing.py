"""The program's span recorder (atvsnet_torch.utils.profiling: StageTimer, TRACER,
device_trace) and the spans the port records where its work happens: the forward and its
five stages, the served request, the eval driver, the fusion.

On the CPU: with no profiler session a span records nothing and costs one shared null
context; under a session spans nest, share their root's request id and keep to the bound;
the forward, DepthEstimator.predict / predict_many, run_eval_pc and fuse_scene record
their spans in order while their results and returned clocks stay as without; device_trace
writes the session's spans beside its one Chrome trace.

On the card (marked `cuda`, skipped here at run time): a span's host interval holds its
kernel's interval on the trace's clock, and its CUDA events time the kernel as the trace
does; the flagship 5-view forward's five stages add up to the forward's device time; the
trace holds no operation named after a span. Run them there with
`python -m pytest --noconftest -q tests/test_torch_tracing.py`. This file imports no JAX.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene, write_eth3d_scene
from atvsnet_torch.models.atvsnet import center_images, multi_view_forward
from atvsnet_torch.params import init_model, load_model
from atvsnet_torch.serving import DepthEstimator
from atvsnet_torch.utils import profiling
from atvsnet_torch.utils.profiling import TRACER, StageTimer

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
STAGES = ["forward.fem", "forward.pairs", "forward.aam1", "forward.refine", "forward.aam2"]
SERVE = ["serve.prepare", "serve.forward", "serve.download", "serve.unpack"]
SMALL = dict(view_num=3, max_h=64, max_w=96, max_d=16)


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _recorded(first):
    """The spans TRACER recorded from index `first` on."""
    return TRACER.spans[first:]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, [s.name for s in spans])
    return found[0]


# ---- the recorder ----


def test_no_session_records_nothing():
    assert not profiling.recording()
    first = len(TRACER.spans)
    ctx = TRACER.span("outside")
    assert ctx is profiling._NULL and TRACER.span("other", device=torch.device("cpu")) is ctx
    with ctx:
        pass
    clock = {"s": 0.0}
    with TRACER.span("timed", into=clock, key="s"):
        time.sleep(0.002)
    assert clock["s"] >= 0.002                # the site's own clock runs with tracing off
    assert len(TRACER.spans) == first and "outside" not in TRACER.totals


def test_nested_spans_share_a_request_and_name_their_parents():
    first = len(TRACER.spans)
    clock = {"s": 0.0}
    before = time.time_ns()
    with _session():
        assert profiling.recording()
        with TRACER.span("a"):
            with TRACER.span("a.b"):
                with TRACER.span("a.b.c", into=clock, key="s"):
                    pass
            with TRACER.span("a.d"):
                pass
        with TRACER.span("e"):
            pass
        with TRACER.span("f", request=41):
            with TRACER.span("f.g"):
                pass
    after = time.time_ns()
    a, b, c, d, e, f, g = _recorded(first)
    assert [s.name for s in (a, b, c, d, e, f, g)] == ["a", "a.b", "a.b.c", "a.d", "e", "f", "f.g"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, a.index, b.index,
                                                                  a.index, None)
    assert g.parent == f.index
    assert a.request == b.request == c.request == d.request != e.request
    assert f.request == g.request == 41
    for s in (a, b, c, d, e, f, g):           # on the time.time_ns() clock
        assert before <= s.start_ns <= s.end_ns <= after and s.events is None
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns
    assert clock["s"] == (c.end_ns - c.start_ns) / 1e9
    assert TRACER.between(a.start_ns, a.end_ns) == [a, b, c, d]


def test_the_bound_counts_what_it_drops():
    timer = StageTimer(limit=3)
    clock = {"s": 0.0}
    with _session():
        for name in ("x", "y", "z", "x", "y"):
            with timer.span(name, into=clock, key="s"):
                pass
    assert [s.name for s in timer.spans] == ["x", "y", "z"] and timer.dropped == 2
    summary = timer.summary()
    assert summary["x"]["count"] == 2 and summary["y"]["count"] == 2 and clock["s"] > 0


class _FakeEvent:
    """A CUDA event on the CPU: record() stamps the next tick of a shared counter."""

    ticks = [0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.ticks[0] += 1
        self.t = _FakeEvent.ticks[0]

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_sibling_device_stages_share_their_boundary_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    cuda = torch.device("cuda")
    timer = StageTimer()
    with _session():
        with timer.span("outer", device=cuda):
            for name in ("a", "b"):
                with timer.span(name, device=cuda):
                    pass
            with timer.span("host"):           # a host span between breaks the chain
                pass
            with timer.span("c", device=cuda):
                pass
        with timer.span("root", device=cuda):  # a root after a root: its own start
            pass
        with timer.span("plain"):
            for name in ("d", "e"):             # inside a host span: each its own pair
                with timer.span(name, device=cuda):
                    pass
    outer, a, b, host, c, root, plain, d, e = timer.spans
    assert b.events[0] is a.events[1] and host.events is None
    assert c.events[0] is not b.events[1] and root.events[0] is not outer.events[1]
    assert e.events[0] is not d.events[1]
    assert len({id(ev) for s in timer.spans for ev in s.events or ()}) == 2 + 2 + 1 + 2 + 2 + 4
    # one tick before a, between b and c, after c: the events outside the shared chain
    assert 1 + a.device_ms() + b.device_ms() + 1 + c.device_ms() + 1 == outer.device_ms()


def test_a_span_that_raises_closes_and_leaves_no_parent_behind():
    first = len(TRACER.spans)
    with _session():
        with pytest.raises(ValueError):
            with TRACER.span("outer"):
                with TRACER.span("inner"):
                    raise ValueError("inside")
        with TRACER.span("after"):
            pass
    outer, inner, after = _recorded(first)
    assert inner.end_ns is not None and outer.end_ns is not None
    assert after.parent is None and after.request != outer.request


def test_device_trace_writes_the_sessions_spans(tmp_path):
    logdir = tmp_path / "trace"
    with TRACER.span("before the session"):
        pass
    with profiling.device_trace(str(logdir)):
        with TRACER.span("op"):
            with TRACER.span("op.matmul"):
                torch.ones(8, 8).matmul(torch.ones(8, 8)).sum()
    assert len(glob.glob(os.path.join(logdir, "*.json"))) == 1
    with open(logdir / "spans.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["name"] for r in lines] == ["op", "op.matmul"]
    assert set(lines[0]) == {"name", "start_ns", "end_ns", "parent", "request", "device_ms"}
    assert lines[0]["parent"] is None and lines[1]["parent"] == 0
    assert lines[0]["request"] == lines[1]["request"]
    assert lines[1]["device_ms"] is None     # no CUDA events on the CPU
    assert lines[0]["start_ns"] <= lines[1]["start_ns"] <= lines[1]["end_ns"] <= \
        lines[0]["end_ns"]


# ---- the program's spans ----


def test_the_forward_records_its_stages_and_its_outputs_do_not_move():
    cfg = PipelineConfig(**SMALL)
    model = init_model(cfg, 0, "cpu")
    images, cams = synthetic_scene(view_num=3, H=64, W=96, D=16, seed=2)
    images = center_images(torch.from_numpy(images))
    off = multi_view_forward(model, images, cams, cfg, out_prob_map=True)
    first = len(TRACER.spans)
    with _session():
        on = multi_view_forward(model, images, cams, cfg, out_prob_map=True)
    spans = _recorded(first)
    forward = _one(spans, "forward")
    stages = _children(spans, forward)
    assert [s.name for s in stages] == STAGES
    for s in stages:
        assert s.request == forward.request and s.events is None
    bounds = [forward.start_ns] + [t for s in stages for t in (s.start_ns, s.end_ns)] + \
        [forward.end_ns]
    assert bounds == sorted(bounds)           # in order, none overlapping, inside forward
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("many", [False, True])
def test_depth_estimator_records_the_request(many):
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    est = DepthEstimator(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 255, size=(30, 28, 3)).astype(np.uint8) for _ in range(3)]
    cams = []
    for v in range(3):
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.eye(4)
        cam[0, :2, 3] = (0.02 * v, 0.011 * v)
        cam[1, :3, :3] = np.array([[28, 0, 14], [0, 28, 15], [0, 0, 1]])
        cam[1, 3] = (1.0, 3.0 / 8, 8, 4.0)
        cams.append(cam)
    call = (lambda: est.predict_many([(images, cams)] * 2)[0]) if many else \
        (lambda: est.predict(images, cams))
    off = call()
    first = len(TRACER.spans)
    with _session():
        on = call()
    spans = _recorded(first)
    request = _one(spans, "serve.request")
    assert request.parent is None
    children = _children(spans, request)
    assert [s.name for s in children] == SERVE
    assert {s.request for s in spans} == {request.request}
    forward = _one(spans, "forward")
    assert forward.parent == _one(spans, "forward.upload").parent == \
        _one(spans, "forward.pack").parent == children[1].index
    # runtime_s is the site's one clock: the spans serve.forward and serve.download
    assert on["runtime_s"] == pytest.approx(sum(
        (s.end_ns - s.start_ns) / 1e9 for s in children[1:3]), rel=1e-9)
    for k in ("depth", "depth_up", "confidence", "confidence_up"):
        np.testing.assert_array_equal(on[k], off[k])


def test_run_eval_pc_records_its_startup_and_keeps_its_clock(tmp_path):
    from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
    from atvsnet_torch.fusion.fuse import fuse_scene

    data_root = str(tmp_path / "data")
    write_eth3d_scene(os.path.join(data_root, "eth3d", "scene"), 3, 64, 96, seed=0, num_d=16)
    kw = dict(view_num=3, max_d=16, max_h=64, max_w=96, params_path=SPHERES, device="cpu",
              load_workers=2, write_workers=1)
    first = len(TRACER.spans)
    with _session():
        clock = run_eval_pc(data_root, str(tmp_path / "on"), ["scene"], **kw)
    spans = _recorded(first)
    off = run_eval_pc(data_root, str(tmp_path / "off"), ["scene"], **kw)
    assert set(clock) == set(off) == {"blocked", "batch_seconds", "scenes"}
    assert list(clock["blocked"]) == list(off["blocked"]) == [
        "load_s", "queue_forward_s", "wait_forward_s", "write_flush_s"]
    assert len(clock["batch_seconds"]) == len(off["batch_seconds"]) == 3
    startup = _one(spans, "eval.startup")
    assert startup.parent is None
    assert [s.name for s in _children(spans, startup)] == ["eval.load_model", "eval.first_load"]
    forwards = [s for s in spans if s.name == "eval.forward"]
    assert [s.request for s in forwards] == [0, 1, 2]
    assert startup.end_ns <= forwards[0].start_ns
    assert [s.request for s in spans if s.name == "eval.load_wait"] == [1, 2]
    assert [s.request for s in spans if s.name == "eval.drain"] == [0, 1, 2]
    assert [s.name for s in spans if s.parent == forwards[1].index] == [
        "forward.upload", "forward", "forward.pack"]
    # each blocked key is its spans' seconds
    seconds = {}
    for s in spans:
        seconds[s.name] = seconds.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    for key, names in (("load_s", ("eval.first_load", "eval.load_wait")),
                       ("queue_forward_s", ("eval.forward",)),
                       ("wait_forward_s", ("eval.drain",)),
                       ("write_flush_s", ("eval.write_flush",))):
        assert clock["blocked"][key] == pytest.approx(sum(seconds[n] for n in names),
                                                      rel=1e-9)
    for stem in ("00000000.pfm", "00000002_prob.pfm"):
        a, b = ((tmp_path / side / "scene" / "depths_atvsnet" / stem).read_bytes()
                for side in ("on", "off"))
        assert a == b, stem

    first = len(TRACER.spans)
    with _session():
        fuse_scene(str(tmp_path / "on" / "scene"), device="cpu")
    spans = _recorded(first)
    scene = _one(spans, "fusion.scene")
    assert [s.name for s in _children(spans, scene)] == [
        "fusion.filter", "fusion.load", "fusion.consistency", "fusion.ply"]


def test_run_eval_pc_that_fails_at_startup_leaves_no_span_open(tmp_path):
    from atvsnet_torch.cli.eval_pointcloud import run_eval_pc

    first = len(TRACER.spans)
    with _session():
        with pytest.raises(SystemExit):
            run_eval_pc(str(tmp_path), str(tmp_path / "out"), [], view_num=3, max_d=16,
                        max_h=64, max_w=96, params_path=str(tmp_path / "missing.npz"),
                        device="cpu")
        with TRACER.span("after"):
            pass
    spans = _recorded(first)
    assert [s.name for s in spans] == ["eval.startup", "eval.load_model", "after"]
    assert all(s.end_ns is not None for s in spans) and spans[-1].parent is None


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _device_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_a_span_holds_its_kernel_on_the_traces_clock(cuda):
    x = torch.randn(4096, 4096, device=cuda)
    for _ in range(3):
        (x @ x).sum().item()                 # warm: cuBLAS's handle, the kernel's first load
    first = len(TRACER.spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert profiling.recording()         # a CUDA-only session sets the flag too
        (x @ x).sum().item()                 # the session's first records may be dropped
        with TRACER.span("t.matmul", device=cuda):
            y = x @ x
            torch.cuda.synchronize()
    span = _one(_recorded(first), "t.matmul")
    kernels = [(s, e) for n, s, e in _device_events(prof)
               if span.start_ns <= s and "gemm" in n.lower()]
    assert len(kernels) == 1, _device_events(prof)
    start, end = kernels[0]
    # the host span holds the kernel's trace interval, and the two clocks agree to 0.5 ms:
    # the span ends as the synchronize returns, right after the kernel (about 9 us apart on
    # an H100, the kernel's end the later)
    tol = 0.5e6
    assert span.start_ns - tol <= start < end <= span.end_ns + tol
    assert abs(span.end_ns - end) < tol
    # the span's events hold the kernel on the device, within the span's host interval
    assert (end - start) / 1e6 <= span.device_ms() <= (span.end_ns - span.start_ns) / 1e6 + 0.1
    del y


@pytest.mark.cuda
def test_flagship_stages_add_up_to_the_forward(cuda):
    cfg = PipelineConfig(view_num=5, max_h=480, max_w=896, max_d=128)
    model = load_model(SPHERES, cfg, cuda)
    images, cams = synthetic_scene(view_num=5, H=480, W=896, D=128, seed=0)
    images = center_images(torch.from_numpy(images).to(cuda))
    multi_view_forward(model, images, cams, cfg)          # cuDNN's algorithm search
    torch.cuda.synchronize()
    first = len(TRACER.spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        multi_view_forward(model, images, cams, cfg)
        torch.cuda.synchronize()
    spans = _recorded(first)
    forward = _one(spans, "forward")
    stages = _children(spans, forward)
    assert [s.name for s in stages] == STAGES
    # adjacent stages share their boundary events: 6 for the stages, 2 for the forward
    assert len({id(e) for s in spans for e in s.events or ()}) == 8
    total = forward.device_ms()
    parts = [s.device_ms() for s in stages]
    assert total > 0 and all(p > 0 for p in parts)
    assert abs(sum(parts) - total) <= 0.03 * total, (parts, total)
    names = {s.name for s in spans}
    assert not any(n in names for n, _, _ in _device_events(prof))
