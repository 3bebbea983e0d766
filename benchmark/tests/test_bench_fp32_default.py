"""The cell serve5.full_tf32passes' parts on the CPU: its configuration and traffic (the fp32
served cell's, key for key, but for the mode, the driver and the limits), its driver at a
tiny size (a sound run comes out correct, one with the forward's depth moved by 5% does not),
the traced window's count of the pass leaves' launches, the leaves' bound on hand-computed
cases, and the cell's three per-layer readers on hand-made runs (each reads the
hand-computed value, and None on an untraced run or where the window holds nothing of its
own)."""

import copy
import time
import types

import pytest
import torch

from atvsnet_torch.utils import profiling
from benchmark import harness
from benchmark.roofline_tf32 import leaf_bound_s, leaf_work
from benchmark.tests.test_bench_harness import TINY, _altered
from benchmark.tests.test_bench_tracing import _run, _tracer

CELL = "serve5.full_tf32passes"
READERS = ["passes.round_ms_per_map.tf32passes", "kernels.tf32conv_roofline.tf32passes",
           "mfu.tf32passes"]
H100 = "NVIDIA H100 80GB HBM3"
# a 3x3 conv of 32 -> 8 channels at stride 1 on (5, 32, 122, 226), pre-padded, and the
# refinement's first transposed conv, (1, 32, 16, 15, 28) -> (1, 16, 33, 31, 57) before
# its crop
CONV = ("conv2d", (5, 32, 122, 226), (8, 32, 3, 3), (1, 1), (0, 0), (1, 1), 1, "default")
DECONV = ("conv_transpose", (1, 32, 16, 15, 28), (32, 16, 3, 3, 3), (2, 2, 2), (0, 0, 0),
          (1, 1, 1), 1, "default")


def _cell():
    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, CELL)
    config = dict(config, **TINY, buckets=[[32, 64]])
    traffic = copy.deepcopy(traffic)
    traffic.update(frame_h=[50, 64], frame_w=[80, 96], rigs=1, views_per_rig=4, pool=3)
    return spec, cell, config, traffic


def test_the_files_are_the_fp32_cells_but_for_the_mode():
    spec = harness.load_spec()
    _, config, traffic = harness.cell_files(spec, CELL)
    _, fp32, frames = harness.cell_files(spec, "serve5.full_frames")
    assert {k for k in config.keys() | fp32.keys() if config.get(k) != fp32.get(k)} == {
        "fp32_precision", "source"}
    assert {k for k in traffic.keys() | frames.keys() if traffic.get(k) != frames.get(k)} == {
        "driver", "limits"}
    run = harness.Run(CELL, config, traffic, 1, 1.0, False, "cpu", ".")
    assert run.pipeline_config().fp32_precision == "default"
    assert run.pipeline_config().compute_dtype == "float32"


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [False, True])
def test_a_run_on_the_cpu(_threads, monkeypatch, fault):
    spec, cell, config, traffic = _cell()
    assert config["fp32_precision"] == "default" and traffic["driver"] == "serve_fp32_default"
    if fault:
        _altered(monkeypatch, 3)      # after the two warm-up requests
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 23, seconds=0.5,
                           trace=False, t_start=time.perf_counter(), device="cpu")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is (not fault), out["compared"]
    assert set(out["metrics"]) == {"served_maps_per_s", "peak_mem_gb", "setup_s"}
    assert set(out["compared"]) == set(traffic["limits"])
    assert {"depth_max", "conf_max"} <= set(out["readings"])


def test_the_traced_window_counts_the_leaves_launches(monkeypatch):
    from atvsnet_torch.ops import fp32_passes, nvcc
    from benchmark.drivers import serve_fp32_default
    from benchmark.trace import DeviceTrace

    monkeypatch.setattr(DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(DeviceTrace, "stop", lambda self: None)
    run = types.SimpleNamespace(counters={}, readings={})
    trace = serve_fp32_default._CountingTrace(run)
    nvcc.count_launch(fp32_passes.pass_conv, "default", CONV)     # a launch before the window
    trace.start()
    nvcc.count_launch(fp32_passes.pass_conv, "default", CONV)
    nvcc.count_launch(fp32_passes.pass_conv_transpose, "default", DECONV)
    nvcc.count_launch(fp32_passes.pass_conv_transpose, "default", DECONV)
    trace.stop()
    assert run.counters == {"pass_shapes": {CONV: 1, DECONV: 2}}
    assert run.readings == {"pass_launches": {"pass_conv": 1, "pass_conv_transpose": 2,
                                              "pass_matmul": 0}}
    fp32_passes.reset_launch_counts()


def test_a_program_without_the_counts_leaves_them_empty(monkeypatch):
    from atvsnet_torch.ops import fp32_passes
    from benchmark.drivers import serve_fp32_default
    from benchmark.trace import DeviceTrace

    monkeypatch.setattr(DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(DeviceTrace, "stop", lambda self: None)
    monkeypatch.delattr(fp32_passes, "reset_launch_counts")
    for name in serve_fp32_default.LEAVES:
        monkeypatch.setattr(fp32_passes, name, lambda *a, **k: None)
    run = types.SimpleNamespace(counters={}, readings={})
    trace = serve_fp32_default._CountingTrace(run)
    trace.start()
    trace.stop()
    assert run.counters == {"pass_shapes": {}}
    assert harness.reader(READERS[1])(_run([("conv", 0, 1)], 1)) is None


def test_the_leaves_bound():
    # the conv: 5 * 8 * 120 * 224 outputs of 32 * 9 multiply-adds; bytes bound it
    macs, nbytes = leaf_work(CONV)
    assert macs == 5 * 8 * 120 * 224 * 32 * 9
    assert nbytes == 4 * (5 * 32 * 122 * 226 + 8 * 32 * 9 + 5 * 8 * 120 * 224)
    t, by = leaf_bound_s(CONV)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # the transposed conv: every input value meets 16 * 27 weights; the output before the
    # crop is (2n - 1) + 2 a side
    macs, nbytes = leaf_work(DECONV)
    assert macs == 16 * 15 * 28 * 32 * 16 * 27
    assert nbytes == 4 * (16 * 15 * 28 * 32 + 32 * 16 * 27 + 16 * 33 * 31 * 57)
    # a matmul of (2, 1000, 512) by (512, 4096): operations bound it; "high" is 3 passes
    mm = ("matmul", (2, 1000, 512), (512, 4096), (), (), (), 1, "default")
    assert leaf_work(mm) == (2000 * 512 * 4096, 4 * (2000 * 512 + 512 * 4096 + 2000 * 4096))
    t, by = leaf_bound_s(mm)
    assert by == "operations" and t == pytest.approx(2 * 2000 * 512 * 4096 / 494.7e12)
    assert leaf_bound_s(mm[:-1] + ("high",))[0] == pytest.approx(3 * t)
    assert leaf_bound_s(mm, "pcie") == (pytest.approx(leaf_work(mm)[1] / 2.0e12), "bytes")
    # a strided, dilated, grouped conv: output (9 - 2 * 2 - 1) // 2 + 1 = 3 a side
    grouped = ("conv2d", (1, 8, 9, 9), (4, 2, 3, 3), (2, 2), (0, 0), (2, 2), 4, "default")
    assert leaf_work(grouped)[0] == 4 * 3 * 3 * 2 * 9


def test_the_roofline_reader(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    # events in ms: two conv kernels that overlap (0-4 ms of device time), a GEMM (5-6), and
    # the rounding's copies and the soft-argmin, which are not counted
    run = _run([("sm90_xmma_fprop_implicit_gemm_tf32f32", 0, 2),
                ("cudnn::ops::nchwToNhwcKernel", 1, 4), ("ampere_sgemm_128x64_nn", 5, 6),
                ("unrolled_elementwise_kernel<direct_copy_kernel_cuda>", 6, 9),
                ("softargmin_kernel", 9, 10)], 2)
    assert harness.reader(READERS[1])(run) is None          # no launches counted
    run.counters["pass_shapes"] = {CONV: 30, DECONV: 12}
    want = 30 * leaf_bound_s(CONV)[0] + 12 * leaf_bound_s(DECONV)[0]
    assert harness.reader(READERS[1])(run) == pytest.approx(100 * want / 5e-3)


def test_the_rounding_reader(monkeypatch):
    spans = [("forward", 10, 40, None, 30.0), ("forward.fem", 11, 15, 0, 7.0),
             ("passes.round", 12, 13, 1, 0.5), ("passes.round", 14, 15, 1, 1.25),
             ("forward", 50, 80, None, 28.0), ("passes.round", 52, 53, 4, 0.75),
             ("passes.round", 120, 130, None, 99.0)]
    monkeypatch.setattr(profiling, "TRACER", _tracer(spans))
    assert harness.reader(READERS[0])(_run([("k", 0, 95)], 2)) == pytest.approx(1.25)
    monkeypatch.setattr(profiling, "TRACER", _tracer(spans[:2] + spans[4:5]))
    assert harness.reader(READERS[0])(_run([("k", 0, 95)], 2)) is None


def test_the_mfu_reader(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    run = _run([("k", 0, 95)], 2)
    run.device, run.flops_traced = torch.device("cuda"), 4.947e12
    assert harness.reader(READERS[2])(run) == pytest.approx(100 * 4.947e12 / 0.1 / 494.7e12)
    run.device = torch.device("cpu")
    assert harness.reader(READERS[2])(run) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_untraced_run(monkeypatch, name):
    read = harness.reader(name)
    assert read(types.SimpleNamespace(trace=None, maps_traced=0, counters={},
                                      device=torch.device("cuda"))) is None
    # a program without the recorder (one without the rounding spans)
    monkeypatch.delattr(profiling, "TRACER")
    if name != "mfu.tf32passes":
        assert read(_run([("k", 0, 95)], 2)) is None
