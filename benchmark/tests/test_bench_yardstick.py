"""The benchmark's arithmetic on the CPU: the FLOP count, the soft-argmin bound, the
statistics, the interval union, the seeded generators and the metric readers."""

import statistics
import types

import numpy as np
import pytest
import torch

from benchmark import flops, harness, roofline, scenes, stats
from benchmark.trace import DeviceTrace, Spans

WEIGHTS = "artifacts/trained_demo/spheres_params.npz"


@pytest.mark.parametrize("views,h,w,d,upsample", [(3, 64, 96, 16, True), (4, 96, 128, 32, False)])
def test_flops_match_the_flop_counter_on_the_port(views, h, w, d, upsample):
    from torch.utils.flop_counter import FlopCounterMode

    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.models.atvsnet import center_images, multi_view_forward
    from atvsnet_torch.params import load_model
    from benchmark.reference import preprocess

    torch.set_num_threads(2)
    rig = scenes.render_rig(views, h, w, 1)
    prep = preprocess.prepare(list(scenes.frames_uint8(rig)), list(scenes.rig_cams(rig, 128)),
                              views, d, h, w)
    cfg = PipelineConfig(view_num=views, max_d=d, max_h=h, max_w=w)
    model = load_model(WEIGHTS, cfg, "cpu")
    with FlopCounterMode(display=False) as counter:
        multi_view_forward(model, center_images(torch.from_numpy(prep["images"])), prep["cams"],
                           cfg, out_prob_map=True, upsample=upsample)
    assert flops.forward_flops(views, h, w, d, upsample=upsample)["total"] == \
        counter.get_total_flops()


def test_flops_scale_with_the_batch_and_the_cells():
    one = flops.forward_flops(8, 480, 896, 128, upsample=False)
    assert flops.forward_flops(8, 480, 896, 128, batch=2, upsample=False)["total"] == \
        2 * one["total"]
    assert 3.9e12 < one["total"] < 4.1e12            # ~4.0 TFLOP per 8-view map
    assert one["stage1_crm"] > one["fem"] > one["refine"]


def test_softargmin_bound():
    # the flagship volume: 13.87 MB over 3.35 TB/s (chip_smoke.py's 4.14 us)
    t, which = roofline.softargmin_bound_s((1, 128, 120, 224))
    assert which == "bytes" and t == pytest.approx(4.1403e-6, rel=1e-4)
    t_pcie, _ = roofline.softargmin_bound_s((1, 128, 120, 224), kind="pcie")
    assert t_pcie == pytest.approx(t * 3.35 / 2.0)
    t_half, _ = roofline.softargmin_bound_s((1, 128, 120, 224), elem_bytes=2)
    assert t - t_half == pytest.approx(128 * 120 * 224 * 2 / 3.35e12)
    assert roofline.part("NVIDIA H100 80GB HBM3") == "sxm"
    assert roofline.part("NVIDIA H100 PCIe") == "pcie"


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 3], 50) == 3
    q1, _, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / 3.5)


def test_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (7, 8), (10, 12)]
    assert stats.union(iv) == [[0, 3], [5, 8], [10, 12]]
    assert stats.covered(iv) == 3 + 3 + 2
    assert stats.gaps(iv, -1, 11) == [(-1, 0), (3, 5), (8, 10)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def test_the_renderer_is_the_ports():
    from atvsnet_torch.data.synthetic import render_multiplane_views

    got = scenes.render_rig(4, 40, 56, 123, threads=2)
    want = render_multiplane_views(4, 40, 56, seed=123, spacing=0.05, rot_step=0.02,
                                   num_spheres=3)
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["depths"], want["depths"])


def _run(cell, seed):
    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, cell)
    traffic = dict(traffic, frame_h=[30, 40], frame_w=[40, 64], rigs=2, views_per_rig=3, pool=5)
    return harness.Run(cell["name"], config, traffic, seed, 1.0, False, "cpu", "/nonexistent")


def test_the_seed_makes_the_traffic():
    from benchmark.drivers.serve_closed_loop import _pool

    big = 2 ** 31 + 11
    a, b, c = _pool(_run("serve5.small_frames", big)), _pool(_run("serve5.small_frames", big)), \
        _pool(_run("serve5.small_frames", big + 1))
    for (ia, ca), (ib, cb) in zip(a, b):
        assert all(np.array_equal(x, y) for x, y in zip(ia, ib))
        assert all(np.array_equal(x, y) for x, y in zip(ca, cb))
    assert any(not np.array_equal(x[0][0], y[0][0]) for x, y in zip(a, c))
    assert {im.shape[:2] for images, _ in a for im in images} <= {
        (h, w) for h in range(30, 41) for w in range(40, 65)}
    r1, r2 = _run("serve5.small_frames", 7), _run("serve5.small_frames", 7)
    assert r1.rng("order").permutation(9).tolist() == r2.rng("order").permutation(9).tolist()


def _traced_run(events, t0, t1, maps):
    tr = DeviceTrace()
    tr.events, tr.t0, tr.t1 = events, t0, t1
    run = types.SimpleNamespace(trace=tr, maps_traced=maps, flops_per_map=67e9,
                                device=torch.device("cpu"), counters={}, spans=Spans(),
                                window_s=2.0)
    return run


def test_the_readers():
    ms = int(1e6)
    # two conv kernels side by side (10-30 ms) count once: 35 ms of conv in 0-35 and 40-50
    events = [("ampere_sgemm_128x64", 0, 30 * ms), ("sm80_xmma_gemm_cf32", 10 * ms, 35 * ms),
              ("fft2d_r2c_32x32", 40 * ms, 50 * ms),
              ("indexSelectLargeIndex", 50 * ms, 55 * ms), ("softargmin_kernel<float>", 60 * ms,
                                                             61 * ms)]
    run = _traced_run(events, 0, 100 * ms, 2)
    assert harness.reader("nn.conv_ms_per_map.batch")(run) == pytest.approx(22.5)
    assert harness.reader("nn.conv_ms_per_map.request")(run) == pytest.approx(22.5)
    assert harness.reader("geometry.gather_ms_per_map.batch")(run) == pytest.approx(2.5)
    assert harness.reader("device.idle_share.batch")(run) == pytest.approx(49.0)
    assert harness.reader("device.idle_share.request")(run) == pytest.approx(49.0)
    assert harness.reader("mfu.batch")(run) is None          # no card, no peak
    assert harness.reader("kernels.softargmin_roofline.batch")(run) is None   # no launches
    run.counters.update(blocked_s=0.5, host_s=[0.01, 0.03, 0.02])
    assert harness.reader("driver.blocked_share")(run) == pytest.approx(25.0)
    assert harness.reader("serving.host_ms")(run) == pytest.approx(20.0)
    run.spans.items += [("scene.fuse_scene", 0, 30 * ms), ("scene.fuse_scene", 0, 50 * ms)]
    assert harness.reader("fusion.ms_per_scene")(run) == pytest.approx(40.0)
    empty = _traced_run([], 0, 100 * ms, 0)
    empty.window_s = None
    for name in ("nn.conv_ms_per_map.batch", "geometry.gather_ms_per_map.batch",
                 "device.idle_share.batch", "serving.host_ms", "driver.blocked_share"):
        assert harness.reader(name)(empty) is None


def test_breakdown_names_the_idle_gaps():
    ms = int(1e6)
    run = _traced_run([("k", 10 * ms, 20 * ms), ("k", 60 * ms, 70 * ms)], 0, 100 * ms, 1)
    spans = Spans()
    spans.items.append(("request.predict", 0, 50 * ms))
    b = run.trace.breakdown(spans)
    assert b["device_ops"] == [["k", 0.02]]
    assert b["idle_gaps"][0] == ["request.predict", 0.04]
    assert sorted(g[1] for g in b["idle_gaps"]) == pytest.approx([0.01, 0.03, 0.04])
    assert {g[0] for g in b["idle_gaps"]} == {"request.predict", "no span"}
