"""The int8mxu cell's parts on the CPU: its driver at a tiny size (a sound run comes out
correct, one with the forward's depth moved by 5% does not, and a configuration whose
act_quant_range the program would not use is refused at set-up), the int8 conv kernel's
bound, and the cell's two per-layer readers on hand-made runs (each reads the hand-computed
value, and None on an untraced run or where the window holds nothing of its own)."""

import copy
import time
import types

import pytest
import torch

from atvsnet_torch.utils import profiling
from benchmark import harness
from benchmark.roofline_int8 import int8_bound_s
from benchmark.tests.test_bench_harness import TINY, _altered
from benchmark.tests.test_bench_tracing import _run, _tracer

CELL = "serve5.int8mxu"
READERS = ["kernels.int8conv_roofline.int8mxu", "quant.ms_per_map.int8mxu"]
# the int8 conv's launches in one 5-view forward at 480x896, D=128, by (B, D, H, W, Ci, Co,
# stride): chip_smoke.py's INT8_MAIN_SHAPES
FORWARD = {(1, 128, 120, 224, 8, 8, 1): 16, (1, 128, 120, 224, 8, 16, 2): 16,
           (1, 128, 120, 224, 8, 1, 1): 14, (1, 128, 120, 224, 32, 8, 1): 4,
           (1, 128, 120, 224, 32, 16, 2): 4, (1, 64, 60, 112, 16, 16, 1): 28,
           (1, 64, 60, 112, 16, 32, 2): 28, (1, 32, 30, 56, 32, 32, 1): 28,
           (1, 32, 30, 56, 32, 64, 2): 28, (1, 16, 15, 28, 64, 64, 1): 28,
           (4, 128, 120, 224, 8, 16, 1): 2}


def _cell():
    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, CELL)
    config = dict(config, **TINY, buckets=[[32, 64]])
    traffic = copy.deepcopy(traffic)
    traffic.update(frame_h=[50, 64], frame_w=[80, 96], rigs=1, views_per_rig=4, pool=3)
    return spec, cell, config, traffic


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [False, True])
def test_a_run_on_the_cpu(_threads, monkeypatch, fault):
    spec, cell, config, traffic = _cell()
    assert config["act_quant"] == "int8mxu" and traffic["driver"] == "serve_int8mxu"
    if fault:
        _altered(monkeypatch, 3)      # after the two warm-up requests
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 19, seconds=0.5,
                           trace=False, t_start=time.perf_counter(), device="cpu")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is (not fault), out["compared"]
    assert set(out["metrics"]) == {"served_maps_per_s", "peak_mem_gb", "setup_s"}
    assert set(out["compared"]) == {"depth_mean_planes", "conf_mean"}
    assert {"depth_max", "conf_max"} <= set(out["readings"])


def test_a_range_the_program_would_not_use_is_refused():
    spec, cell, config, traffic = _cell()
    config["act_quant_range"] = 4.0
    with pytest.raises(SystemExit, match="act_quant_range"):
        harness.run_cell(spec, cell, config, traffic, seed=5, seconds=0.1, trace=False,
                         t_start=time.perf_counter(), device="cpu")


def test_the_traced_window_counts_the_kernels_launches(monkeypatch):
    from atvsnet_torch.ops import int8_conv
    from benchmark.drivers import serve_int8mxu
    from benchmark.trace import DeviceTrace

    monkeypatch.setattr(DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(DeviceTrace, "stop", lambda self: None)
    run = types.SimpleNamespace(counters={}, readings={})
    trace = serve_int8mxu._CountingTrace(run)
    int8_conv.conv3d_int8_cuda.launches = 5          # a launch before the window
    trace.start()
    key = (1, 16, 15, 28, 64, 64, 1)
    int8_conv.conv3d_int8_cuda.shape_launches[key] = 2
    int8_conv.conv3d_int8_cuda.path_launches["ring_cluster"] = 2
    trace.stop()
    assert run.counters == {"int8_conv_shapes": {key: 2}}
    assert run.readings == {"int8_conv_path_launches": {"generic": 0, "ring": 0,
                                                        "ring_cluster": 2}}
    int8_conv.reset_launch_counts()


def test_the_int8_bound():
    # the largest class reads and writes 137.6 MB: bytes; the smallest computes 1.49 GOP
    t, by = int8_bound_s((1, 128, 120, 224, 8, 8, 1))
    assert by == "bytes" and t == pytest.approx((27_525_120 * 5 + 1_728 + 4) / 3.35e12)
    t, by = int8_bound_s((1, 16, 15, 28, 64, 64, 1))
    assert by == "operations" and t == pytest.approx(2 * 27 * 64 * 430_080 / 1979e12)
    assert int8_bound_s((1, 16, 15, 28, 64, 64, 1), kind="pcie")[0] > t
    # 196 launches of 11 classes, 2.64 ms a forward (PERF.md's int8 row)
    assert sum(FORWARD.values()) == 196
    assert sum(n * int8_bound_s(k)[0] for k, n in FORWARD.items()) == pytest.approx(
        2.64e-3, rel=0.01)


def test_the_roofline_reader(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    # events in ms: two int8 conv kernels that overlap (0-4 ms of device time) and another
    run = _run([("void conv3d_int8_ring_kernel<8, 1>", 0, 2), ("void conv3d_int8_kernel<1>", 1, 4),
                ("softargmin_kernel", 5, 6)], 2)
    assert harness.reader(READERS[0])(run) is None          # no launches counted
    run.counters["int8_conv_shapes"] = {(1, 128, 120, 224, 8, 8, 1): 40,
                                        (1, 16, 15, 28, 64, 64, 1): 100}
    want = 40 * int8_bound_s((1, 128, 120, 224, 8, 8, 1))[0] + \
        100 * int8_bound_s((1, 16, 15, 28, 64, 64, 1))[0]
    assert harness.reader(READERS[0])(run) == pytest.approx(100 * want / 4e-3)


def test_the_quant_reader(monkeypatch):
    spans = [("forward", 10, 40, None, 30.0), ("forward.pairs", 11, 30, 0, 15.0),
             ("quant.operands", 12, 13, 1, 0.5), ("quant.act", 14, 15, 1, 1.25),
             ("quant.act", 16, 17, 1, 0.75), ("forward", 50, 80, None, 28.0),
             ("quant.operands", 52, 53, 5, 0.5), ("quant.act", 120, 130, None, 99.0)]
    monkeypatch.setattr(profiling, "TRACER", _tracer(spans))
    assert harness.reader(READERS[1])(_run([("k", 0, 95)], 2)) == pytest.approx(1.5)
    # quant.act alone (the link spans of int8s): no reading
    links_only = [s for s in spans if s[0] != "quant.operands"]
    monkeypatch.setattr(profiling, "TRACER", _tracer(links_only))
    assert harness.reader(READERS[1])(_run([("k", 0, 95)], 2)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_untraced_run(monkeypatch, name):
    read = harness.reader(name)
    assert read(types.SimpleNamespace(trace=None, maps_traced=0, counters={})) is None
    # a program without the recorder (one without the quantization spans)
    monkeypatch.delattr(profiling, "TRACER")
    assert read(_run([("k", 0, 95)], 2)) is None
