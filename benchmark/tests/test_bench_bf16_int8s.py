"""The cell serve5.bf16_int8s' parts on the CPU: its configuration and traffic (the fp32
served cell's, key for key, but for the mode, the driver and the limits), its driver at a
tiny size (a sound run comes out correct; one with the mode's reference at 4 significant
bits in the forward's place does not), the traced window's count of the bf16
conv leaves' launches, the leaves' bound on hand-computed cases, and the cell's three
per-layer readers on hand-made runs (each reads the hand-computed value, and None on an
untraced run or where the window holds nothing of its own)."""

import copy
import time
import types

import pytest
import torch

from atvsnet_torch.utils import profiling
from benchmark import harness
from benchmark.roofline_bf16 import leaf_bound_s, leaf_work
from benchmark.tests.test_bench_harness import TINY
from benchmark.tests.test_bench_tracing import _run, _tracer

CELL = "serve5.bf16_int8s"
READERS = ["quant.ms_per_map.bf16int8s", "kernels.bf16conv_roofline.bf16int8s", "mfu.bf16int8s"]
H100 = "NVIDIA H100 80GB HBM3"
# a 3x3 conv of 32 -> 8 channels at stride 1 on (5, 32, 122, 226), pre-padded, and the
# refinement's first transposed conv, (1, 32, 16, 15, 28) -> (1, 16, 33, 31, 57) before
# its crop, keyed as nn.layers.bf16_conv counts them
CONV = ("conv2d", (5, 32, 122, 226), (8, 32, 3, 3), (1, 1), (0, 0), (1, 1), 1)
DECONV = ("conv_transpose", (1, 32, 16, 15, 28), (32, 16, 3, 3, 3), (2, 2, 2), (0, 0, 0),
          (1, 1, 1), 1)


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
        "compute_dtype", "act_quant", "act_quant_range", "warp_quant", "source", "assumed"}
    assert config["assumed"][:len(fp32["assumed"])] == fp32["assumed"]
    assert {k for k in traffic.keys() | frames.keys() if traffic.get(k) != frames.get(k)} == {
        "driver", "limits"}
    cfg = harness.Run(CELL, config, traffic, 1, 1.0, False, "cpu", ".").pipeline_config()
    assert (cfg.compute_dtype, cfg.act_quant, cfg.warp_quant) == ("bfloat16", "int8s", "int8")
    assert cfg.act_quant_range == config["act_quant_range"] == 6.0


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["program", "bits4"])
def test_a_run_on_the_cpu(_threads, monkeypatch, variant):
    """The check at 64x96, D=16, with the cell's limits. At this size bf16's own chaos (the
    program reads 0.03-0.04 planes) lies within 2-4x of the card's control (a), the
    reference at 6 significant bits (0.07-0.13 here, inside the cell's limits), which the
    card tells apart 10x and more (PERF.md section 2); so the run here puts the coarser
    4-bit reference in the forward's place (0.25-0.33 planes on 4 seeds), which fails."""
    import atvsnet_torch.serving as serving
    from benchmark.drivers import serve_bf16_int8s

    spec, cell, config, traffic = _cell()
    assert traffic["driver"] == "serve_bf16_int8s"
    if variant == "bits4":
        monkeypatch.setattr(serving, "multi_view_forward", serve_bf16_int8s.reference_forward(
            harness.os.path.join(harness.ROOT, config["weights"]), torch.device("cpu"), 4))
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 25, seconds=0.5,
                           trace=False, t_start=time.perf_counter(), device="cpu")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is (variant == "program"), out["compared"]
    assert set(out["metrics"]) == {"served_maps_per_s", "peak_mem_gb", "setup_s"}
    assert set(out["compared"]) == set(traffic["limits"])
    assert {"depth_max", "conf_max"} <= set(out["readings"])


def test_a_configuration_at_another_range_is_refused():
    from benchmark.drivers import serve_bf16_int8s

    spec, cell, config, traffic = _cell()
    run = harness.Run(CELL, dict(config, act_quant_range=4.0), traffic, 1, 1.0, False, "cpu",
                      ".")
    with pytest.raises(SystemExit, match="act_quant_range"):
        serve_bf16_int8s.setup(run)


def test_the_traced_window_counts_the_leaves_launches(monkeypatch):
    from atvsnet_torch.nn import layers
    from atvsnet_torch.ops import nvcc
    from benchmark.drivers import serve_bf16_int8s
    from benchmark.trace import DeviceTrace

    monkeypatch.setattr(DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(DeviceTrace, "stop", lambda self: None)
    run = types.SimpleNamespace(counters={}, readings={})
    trace = serve_bf16_int8s._CountingTrace(run)
    nvcc.count_launch(layers.bf16_conv, "conv2d", CONV)     # a launch before the window
    trace.start()
    nvcc.count_launch(layers.bf16_conv, "conv2d", CONV)
    nvcc.count_launch(layers.bf16_conv, "conv_transpose", DECONV)
    nvcc.count_launch(layers.bf16_conv, "conv_transpose", DECONV)
    trace.stop()
    assert run.counters == {"bf16_conv_shapes": {CONV: 1, DECONV: 2}}
    assert run.readings == {"bf16_conv_launches": {"conv2d": 1, "conv3d": 0,
                                                   "conv_transpose": 2}}
    layers.reset_launch_counts()


def test_a_program_without_the_counts_leaves_them_empty(monkeypatch):
    from atvsnet_torch.nn import layers
    from benchmark.drivers import serve_bf16_int8s
    from benchmark.trace import DeviceTrace

    monkeypatch.setattr(DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(DeviceTrace, "stop", lambda self: None)
    monkeypatch.delattr(layers, "reset_launch_counts")
    monkeypatch.delattr(layers, "bf16_conv")
    run = types.SimpleNamespace(counters={}, readings={})
    trace = serve_bf16_int8s._CountingTrace(run)
    trace.start()
    trace.stop()
    assert run.counters == {"bf16_conv_shapes": {}}
    assert harness.reader(READERS[1])(_run([("conv", 0, 1)], 1)) is None


def test_the_leaves_bound():
    # the conv: 5 * 8 * 120 * 224 outputs of 32 * 9 multiply-adds, 2 bytes a value; bytes
    # bound it
    macs, nbytes = leaf_work(CONV)
    assert macs == 5 * 8 * 120 * 224 * 32 * 9
    assert nbytes == 2 * (5 * 32 * 122 * 226 + 8 * 32 * 9 + 5 * 8 * 120 * 224)
    t, by = leaf_bound_s(CONV)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # the transposed conv: every input value meets 16 * 27 weights; the output before the
    # crop is (2n - 1) + 2 a side
    macs, nbytes = leaf_work(DECONV)
    assert macs == 16 * 15 * 28 * 32 * 16 * 27
    assert nbytes == 2 * (16 * 15 * 28 * 32 + 32 * 16 * 27 + 16 * 33 * 31 * 57)
    # a wide conv3d, (1, 64, 32, 60, 112) by 64 -> 64 3x3x3 taps, stride 1, padding 1:
    # operations bound it on the bf16 tensor cores
    wide = ("conv3d", (1, 64, 32, 60, 112), (64, 64, 3, 3, 3), (1, 1, 1), (1, 1, 1),
            (1, 1, 1), 1)
    macs, nbytes = leaf_work(wide)
    assert macs == 64 * 32 * 60 * 112 * 64 * 27
    t, by = leaf_bound_s(wide)
    assert by == "operations" and t == pytest.approx(2 * macs / 989.4e12)
    assert leaf_bound_s(wide, "pcie") == (pytest.approx(2 * macs / 756e12), "operations")
    # a strided, dilated, grouped conv: output (9 - 2 * 2 - 1) // 2 + 1 = 3 a side
    grouped = ("conv2d", (1, 8, 9, 9), (4, 2, 3, 3), (2, 2), (0, 0), (2, 2), 4)
    assert leaf_work(grouped)[0] == 4 * 3 * 3 * 2 * 9


def test_the_roofline_reader(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    # events in ms: two conv kernels that overlap (0-4 ms of device time), a GEMM (5-6), and
    # the lattices' elementwise kernels and the soft-argmin, which are not counted
    run = _run([("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", 0, 2),
                ("cudnn::ops::nchwToNhwcKernel", 1, 4), ("ampere_sgemm_128x64_nn", 5, 6),
                ("vectorized_elementwise_kernel<round_kernel_cuda>", 6, 9),
                ("softargmin_kernel", 9, 10)], 2)
    assert harness.reader(READERS[1])(run) is None          # no launches counted
    run.counters["bf16_conv_shapes"] = {CONV: 30, DECONV: 12}
    want = 30 * leaf_bound_s(CONV)[0] + 12 * leaf_bound_s(DECONV)[0]
    assert harness.reader(READERS[1])(run) == pytest.approx(100 * want / 5e-3)


def test_the_lattice_reader(monkeypatch):
    spans = [("forward", 10, 40, None, 30.0), ("forward.pairs", 11, 25, 0, 12.0),
             ("quant.warp", 12, 13, 1, 0.5), ("quant.act", 14, 15, 1, 1.25),
             ("forward", 50, 80, None, 28.0), ("quant.act", 52, 53, 4, 0.75),
             ("quant.warp", 54, 55, 4, 0.25), ("quant.warp", 120, 130, None, 99.0)]
    monkeypatch.setattr(profiling, "TRACER", _tracer(spans))
    assert harness.reader(READERS[0])(_run([("k", 0, 95)], 2)) == pytest.approx(1.375)
    # no warp spans (the int8mxu cell's window, or a program without them): nothing to read
    monkeypatch.setattr(profiling, "TRACER", _tracer(
        [s for s in spans if s[0] != "quant.warp"]))
    assert harness.reader(READERS[0])(_run([("k", 0, 95)], 2)) is None


def test_the_mfu_reader(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    run = _run([("k", 0, 95)], 2)
    run.device, run.flops_traced = torch.device("cuda"), 9.894e12
    assert harness.reader(READERS[2])(run) == pytest.approx(100 * 9.894e12 / 0.1 / 989.4e12)
    run.device = torch.device("cpu")
    assert harness.reader(READERS[2])(run) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_untraced_run(monkeypatch, name):
    read = harness.reader(name)
    assert read(types.SimpleNamespace(trace=None, maps_traced=0, counters={},
                                      device=torch.device("cuda"))) is None
    # a program without the recorder (one without the lattice spans)
    monkeypatch.delattr(profiling, "TRACER")
    if name != "mfu.bf16int8s":
        assert read(_run([("k", 0, 95)], 2)) is None
