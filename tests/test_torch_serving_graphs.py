"""DepthEstimator's CUDA graphs (serving.ServingGraph): one captured program per key, its
launch counters and spans carried over to every replay, and the eager path everywhere the
graph does not engage. This file imports no JAX.

On the CPU: a CPU estimator serves eagerly, each request equal to packed_forward's answer
to the bit, and captures nothing; the key of a request (bucket, batch, dtype, preprocessed);
no capture with a mesh, on the CPU or with a forward put in multi_view_forward's place; the
resize matrices uploaded once per device. The bookkeeping of a replay runs on the CPU with
a stand-in graph (_StubGraph: the capture remembers the normalization and device_forward's
call, a replay reruns them into the captured row with its host-side counts and spans
discarded, as the device alone would): the answers come from the static buffers, a replay adds exactly what the capture
counted (the counters that count only under a profiler only under one) and records the
eager forward's spans; a Span given its device ms exports it; the benchmark's graph share.

On the card (marked `cuda`, skipped here at run time), in each served numerics at 480x896
and 256x320: three requests with their own images and cams, each replay equal to the eager
packed_forward to the bit (deterministic cuDNN), the replay's launch counters, TRACER's
counters and spans equal to an eager forward's with every span's device ms read, and the
capture's max_memory_allocated within 1% of the eager forward's. Run them there with
`python -m pytest --noconftest -q tests/test_torch_serving_graphs.py`.
"""

import contextlib
import json
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atvsnet_torch import serving
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.geometry import depth_regression
from atvsnet_torch.geometry.cameras import scale_camera_np
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import nvcc
from atvsnet_torch.serving import DepthEstimator, graph_key, packed_forward, unpack_rows
from atvsnet_torch.utils.profiling import TRACER, Span, StageTimer, Template
from atvsnet_torch.utils.transfer import finish_download

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
SMALL = dict(view_num=3, max_d=8, max_h=32, max_w=32)
MAPS = ("depth", "depth_up", "confidence", "confidence_up")
# bf16 with the int8 links and sweep volumes: launches counted only under a profiler
# (nn.layers.bf16_conv) and TRACER's counters (quant.act, quant.warp) in one forward
COUNTED = dict(compute_dtype="bfloat16", act_quant="int8s", warp_quant="int8")


def _request(seed, H=30, W=28, views=3, D=8):
    rng = np.random.RandomState(seed)
    images = [rng.randint(0, 255, size=(H, W, 3)).astype(np.uint8) for _ in range(views)]
    cams = []
    for v in range(views):
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.eye(4)
        cam[0, :2, 3] = (0.02 * v + 0.001 * seed, 0.011 * v)
        cam[1, :3, :3] = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]])
        cam[1, 3] = (1.0 + 0.01 * seed, 3.0 / D, D, 4.0)
        cams.append(cam)
    return images, cams


def _eager_answer(est, images, cams):
    """predict's answer computed by packed_forward itself."""
    c, batch = est._prepare_request(images, cams, False)
    rows = finish_download(*packed_forward(est.model, c, batch["images"], batch["cams"],
                                           est.device, False, est._maps_of(c),
                                           out_prob_map=est._with_conf(c)))
    return est._result(c, unpack_rows(rows, *est._map_layout(c))[0], batch["valid_hw"], 0.0)


def _session():
    return profile(activities=[ProfilerActivity.CPU])


# ---- the eager path ----


def test_a_cpu_estimator_serves_eagerly_and_equals_packed_forward():
    est = DepthEstimator(PipelineConfig(**SMALL), seed=0, device="cpu")
    before = dict(TRACER.counters)
    with _session():
        got = [est.predict(*_request(k)) for k in range(2)]
    counted = {k: v - before.get(k, 0) for k, v in TRACER.counters.items()
               if k.startswith("serve.graph.")}
    assert counted == {"serve.graph.eager": 2}
    assert est._graphs == {} and est._stream is None
    for k, out in enumerate(got):
        want = _eager_answer(est, *_request(k))
        for m in MAPS:
            np.testing.assert_array_equal(out[m], want[m])


@pytest.mark.parametrize("change, same", [
    (dict(), True), (dict(images=np.ones((1, 3, 32, 32, 3), np.uint8)), True),
    (dict(bucket=dict(max_h=64)), False), (dict(images=np.zeros((2, 3, 32, 32, 3), np.uint8)), False),
    (dict(images=np.zeros((1, 3, 32, 32, 3), np.float32)), False), (dict(centered=True), False)],
    ids=["same", "other_values", "other_bucket", "batch_2", "float", "preprocessed"])
def test_the_graph_key_is_bucket_batch_dtype_and_preprocessing(change, same):
    c = PipelineConfig(**SMALL)
    base = dict(c=c, images=np.zeros((1, 3, 32, 32, 3), np.uint8), centered=False)
    other = base | {k: v for k, v in change.items() if k != "bucket"}
    if "bucket" in change:
        other["c"] = c.replace(**change["bucket"])
    assert (graph_key(**base) == graph_key(**other)) is same


@pytest.mark.parametrize("case", ["cuda", "cpu", "mesh", "substituted", "two_view_substituted"])
def test_graphs_engage_only_on_cuda_without_a_mesh_with_the_packages_forward(case, monkeypatch):
    est = DepthEstimator(PipelineConfig(**SMALL), seed=0, device="cpu")
    if case != "cpu":
        est.device = torch.device("cuda")     # the decision alone: nothing runs here
    if case == "mesh":
        est.mesh = object()
    if case == "substituted":
        monkeypatch.setattr(serving, "multi_view_forward", lambda *a, **k: None)
    if case == "two_view_substituted":
        monkeypatch.setattr(serving, "two_view_forward", lambda *a, **k: None)
    assert est._graphable() is (case == "cuda")


def test_a_resize_matrix_is_uploaded_once_per_device():
    cpu = torch.device("cpu")
    m = depth_regression._matrix(17, 5, cpu)
    assert depth_regression._matrix(17, 5, "cpu") is m
    assert depth_regression._DEVICE_MATRICES[(17, 5, cpu)] is m
    np.testing.assert_array_equal(m.numpy(), depth_regression._align_corners_matrix(17, 5))
    assert depth_regression._matrix(5, 17, cpu) is not m


# ---- the graph path, with a stand-in graph on the CPU ----


class _StubGraph:
    """CUDAGraph's stand-in: _stub_capture remembers the normalization and the call of
    device_forward made under it, and its row; replay() reruns them into the row with the
    host's counts and spans discarded (what the device alone runs)."""

    capturing = None

    def __init__(self):
        self.call = self.row = self.inputs = None
        self.replays = 0

    def replay(self):
        before = nvcc.snapshot_counts()
        with TRACER.template():
            out = self.call()
        nvcc.counts_since(before)
        self.row.copy_(out)
        self.replays += 1


@contextlib.contextmanager
def _stub_capture(graph, pool=None, stream=None):
    _StubGraph.capturing = graph
    try:
        yield
    finally:
        _StubGraph.capturing = None


@pytest.fixture
def stub_graphs(monkeypatch):
    """DepthEstimator on the CPU takes its graph path with _StubGraph for CUDAGraph: the
    captured block is normalized(static images) then device_forward, both rerun by a
    replay."""
    forward, norm = serving.device_forward, serving.normalized

    def remembered_norm(images, centered):
        if _StubGraph.capturing is not None:
            _StubGraph.capturing.inputs = (images, centered)
        return norm(images, centered)

    def remembered(model, c, x, *args, **kw):
        graph = _StubGraph.capturing
        if graph is None:                      # packed_forward's call
            return forward(model, c, x, *args, **kw)
        images, centered = graph.inputs
        graph.call = lambda: forward(model, c, norm(images, centered), *args, **kw)
        graph.row = forward(model, c, x, *args, **kw)
        return graph.row

    monkeypatch.setattr(serving, "normalized", remembered_norm)
    monkeypatch.setattr(serving, "device_forward", remembered)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(DepthEstimator, "_graphable", lambda self: True)
    monkeypatch.setattr(DepthEstimator, "_capture_stream",
                        lambda self: contextlib.nullcontext())


def _counts(fn):
    """fn()'s additions to the bf16 conv leaf's launches and to TRACER's counters."""
    L.reset_launch_counts()
    before = dict(TRACER.counters)
    fn()
    counters = {k: v - before.get(k, 0) for k, v in TRACER.counters.items()
                if v != before.get(k, 0)}
    try:
        return (L.bf16_conv.launches, dict(L.bf16_conv.path_launches),
                dict(L.bf16_conv.shape_launches)), counters
    finally:
        L.reset_launch_counts()


def test_replays_answer_from_the_static_buffers(stub_graphs):
    est = DepthEstimator(PipelineConfig(**SMALL), seed=0, device="cpu")
    # copies: on the CPU start_download hands back the row itself, which the next replay
    # overwrites (from a CUDA device it copies into pinned memory of its own)
    got = [{m: np.array(v) for m, v in est.predict(*_request(k)).items()} for k in range(3)]
    (graph,) = est._graphs.values()
    assert graph.graph.replays == 3          # the first request's answer is a replay's too
    answers = [_eager_answer(est, *_request(k)) for k in range(3)]
    for out, want in zip(got, answers):
        for m in MAPS:
            np.testing.assert_array_equal(out[m], want[m])
    assert not np.array_equal(got[0]["depth"], got[1]["depth"])


def test_a_replay_counts_what_the_capture_counted(stub_graphs):
    est = DepthEstimator(PipelineConfig(**SMALL, **COUNTED), seed=0, device="cpu")
    request = _request(0)
    with _session():
        eager = _counts(lambda: _eager_answer(est, *request))
        first = _counts(lambda: est.predict(*request))     # eager, capture, replay
        replay = _counts(lambda: est.predict(*request))
    (graph,) = est._graphs.values()
    assert eager[0][0] > 0 and eager[1]["quant.act.elements"] > 0
    assert eager[1]["quant.warp.elements"] > 0
    # the capture adds nothing of its own: the first request counts its eager forward and
    # its replay, and every replay what one eager forward counts
    assert replay[0] == eager[0]
    assert replay[1] == eager[1] | {"serve.graph.replays": 1}
    assert first[0][0] == 2 * eager[0][0]
    assert {k: first[1][k] for k in eager[1]} == {k: 2 * v for k, v in eager[1].items()}
    assert [first[1][f"serve.graph.{k}"] for k in ("eager", "captures", "replays")] == [1, 1, 1]
    assert graph.template.counters == eager[1]
    # without a session neither the bf16 conv leaf's launches nor TRACER's counters move
    off = _counts(lambda: est.predict(*request))
    assert off == ((0, dict.fromkeys(L.BF16_CONV_KINDS, 0), {}), {})


def test_a_replay_of_an_ungated_launcher_counts_without_a_session():
    def fn():
        pass

    def gated():
        pass

    reset = nvcc.launch_counts(("a", "b"), fn)
    nvcc.launch_counts(("a",), gated, recorded_only=True)
    try:
        before = nvcc.snapshot_counts()
        nvcc.count_launch(fn, "a", (1,))
        nvcc.count_launch(fn, "b", (2,))
        nvcc.count_launch(gated, "a", (3,))
        deltas = nvcc.counts_since(before)
        assert fn.launches == gated.launches == 0           # set back to the snapshot
        by = {d[0].__name__: d[1:] for d in deltas}
        assert by == {"fn": (False, 2, {"a": 1, "b": 1}, {(1,): 1, (2,): 1}),
                      "gated": (True, 1, {"a": 1}, {(3,): 1})}
        nvcc.add_counts(deltas, recording=False)
        nvcc.add_counts(deltas, recording=False)
        assert (fn.launches, fn.path_launches, fn.shape_launches) == (
            4, {"a": 2, "b": 2}, {(1,): 2, (2,): 2})
        assert gated.launches == 0
        nvcc.add_counts(deltas, recording=True)
        assert fn.launches == 6 and gated.launches == 1 and gated.shape_launches == {(3,): 1}
    finally:
        nvcc.LAUNCHERS[:] = [e for e in nvcc.LAUNCHERS if e[0] not in (fn, gated)]
    reset()


def test_a_replay_records_the_eager_forwards_spans(stub_graphs):
    est = DepthEstimator(PipelineConfig(**SMALL, **COUNTED), seed=0, device="cpu")
    request = _request(1)
    est.predict(*request)
    with _session():
        first = len(TRACER.spans)
        _eager_answer(est, *request)
        eager = TRACER.spans[first:]
        first = len(TRACER.spans)
        est.predict(*request)
        served = TRACER.spans[first:]
    names = {s.index: s.name for s in eager + served}
    order = [s.name for s in served]
    assert order[:7] == ["serve.request", "serve.prepare", "serve.forward", "forward.upload",
                         "serve.graph.replay", "forward.pack", "serve.download"]
    assert order[-1] == "serve.unpack"
    serve_forward, launch = served[2], served[4]
    assert launch.parent == served[3].parent == served[5].parent == serve_forward.index
    # the forward's spans (packed_forward's but its host spans forward.upload and .pack)
    # follow serve.download, the forward under serve.forward, all on the replay's launch
    # and with the request's id
    replayed = served[7:-1]
    host = {"forward.upload", "forward.pack"}
    want = [(s.name, names.get(s.parent)) for s in eager if s.name not in host]
    got = [(s.name, names[s.parent]) for s in replayed]
    assert got == [(n, "serve.forward" if n == "forward" else p) for n, p in want]
    (interval,) = {(s.start_ns, s.end_ns) for s in replayed}
    assert launch.start_ns <= interval[0] <= interval[1] <= launch.end_ns
    assert {s.request for s in replayed} == {serve_forward.request}
    assert {"quant.act", "quant.warp"} <= {n for n, _ in got}


def test_a_span_given_its_device_ms_is_exported(tmp_path):
    timer = StageTimer()
    template = Template()
    template.spans += [Span("forward", 0, None, 0, None, 0, ms=3.5),
                       Span("forward.fem", 0, 0, 0, None, 1, ms=1.25)]
    with _session():
        with timer.span("serve.forward") as parent:
            pass
    timer.replay(template, parent, 10, 20)
    timer.replay(template, None, 10, 20)     # nothing without a parent (no session)
    path = str(tmp_path / "spans.jsonl")
    timer.export(path)
    lines = [json.loads(ln) for ln in open(path)]
    assert [(d["name"], d["parent"], d["device_ms"], d["start_ns"], d["end_ns"])
            for d in lines[1:]] == [("forward", 0, 3.5, 10, 20), ("forward.fem", 1, 1.25, 10, 20)]
    assert {d["request"] for d in lines} == {lines[0]["request"]}


def test_the_benchmarks_graph_share_reads_the_replays(stub_graphs):
    from benchmark.metrics.graphs import graph_share

    est = DepthEstimator(PipelineConfig(**SMALL), seed=0, device="cpu")
    est.predict(*_request(0))
    run = types.SimpleNamespace(trace=types.SimpleNamespace(t0=None, t1=None), maps_traced=1)
    with _session():
        run.trace.t0 = time.time_ns()
        est.predict(*_request(1))
        est.predict_many([_request(2), _request(3)])              # batch 2: eager, capture
        run.trace.t1 = time.time_ns()
    # three forwards in the window (the predict_many's eager one and its replay), two replays
    assert graph_share(run) == pytest.approx(200.0 / 3)
    run.trace.t0 = run.trace.t1
    assert graph_share(run) is None


# ---- on the card ----

GRAPH_MODES = {"highest": {}, "int8mxu": dict(act_quant="int8mxu"),
               "default": dict(fp32_precision="default"),
               "bf16_int8s": dict(compute_dtype="bfloat16", act_quant="int8s", warp_quant="int8")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _card_requests(hw, n):
    """n requests of their own images and cams (request cams: the frames' intrinsics, a
    metric depth row) at the flagship size, cut to fit (h, w)."""
    out = []
    for seed in range(n):
        images, cams = synthetic_scene(view_num=5, H=480, W=896, D=128, seed=seed + 40)
        frames = [np.uint8(im * 255.0)[:hw[0] - 16, :hw[1]] for im in images[0]]
        request_cams = []
        for cam in cams[0]:
            cam = scale_camera_np(cam, 4.0)             # sample_scale 0.25
            start, interval = cam[1, 3, 0], cam[1, 3, 1]
            cam[1, 3] = (1.0 / (start + interval * 128), 0.0, 128, 1.0 / start)
            request_cams.append(cam)
        out.append((frames, request_cams))
    return out


def _profiled(fn):
    """fn()'s launch counts, TRACER counters (but serve.*) and device spans under a CUDA
    profiler session."""
    before, counters, first = nvcc.snapshot_counts(), dict(TRACER.counters), len(TRACER.spans)
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    launches = {f"{f.__module__}.{f.__name__}": (n, paths, shapes)
                for f, _, n, paths, shapes in nvcc.counts_since(before)}
    device = [s for s in TRACER.spans[first:] if s.events is not None or s.ms is not None]
    names = {s.index: s.name for s in device}
    return (launches,
            {k: v - counters.get(k, 0) for k, v in TRACER.counters.items()
             if v != counters.get(k, 0) and not k.startswith("serve.")},
            [(s.name, names.get(s.parent)) for s in device], [s.device_ms() for s in device])


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(480, 896), (256, 320)], ids=["480x896", "256x320"])
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_replays_equal_the_eager_forward_on_the_card(cuda, mode, hw):
    torch.backends.cudnn.deterministic = True
    try:
        est = DepthEstimator(PipelineConfig(**GRAPH_MODES[mode]), params_path=SPHERES)
        est.add_bucket(max_h=256, max_w=320)
        prepared = [est._prepare_request(f, c, False) for f, c in _card_requests(hw, 3)]
        c = prepared[0][0]
        assert (c.max_h, c.max_w) == hw

        def eager(batch):
            with est._capture_stream():     # the stream of a key's eager first request
                rows = finish_download(*packed_forward(
                    est.model, c, batch["images"], batch["cams"], est.device, False,
                    est._maps_of(c), out_prob_map=est._with_conf(c)))
            return unpack_rows(rows, *est._map_layout(c))[0]

        def replay(batch):
            return est._forward(c, batch["images"], batch["cams"], False)[0][0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = [eager(b) for _, b in prepared]
        eager_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = [replay(b) for _, b in prepared]        # the first: eager, capture, replay
        assert torch.cuda.max_memory_allocated() <= 1.01 * eager_peak
        assert len(est._graphs) == 1
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert not np.array_equal(got[0]["depth"], got[1]["depth"])
        e = _profiled(lambda: eager(prepared[1][1]))
        r = _profiled(lambda: replay(prepared[2][1]))
        assert r[:3] == e[:3]
        assert all(ms is not None and ms > 0 for ms in r[3])
    finally:
        torch.backends.cudnn.deterministic = False
