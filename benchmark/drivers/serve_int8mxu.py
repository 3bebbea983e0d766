"""The closed-loop served traffic of serve_closed_loop under act_quant="int8mxu", checked
against the plain int8mxu reference (benchmark/reference/int8mxu.py).

Set-up, the window and the release are serve_closed_loop's. Set-up first holds the
configuration's `act_quant_range` to the value the program will use (the harness's
`pipeline_config` does not pass it: PipelineConfig's default applies). A traced window also
counts the int8 conv kernel's launches by shape (ops.int8_conv.conv3d_int8_cuda
.shape_launches, from zero at the trace's start) into run.counters["int8_conv_shapes"] when
the trace stops, for the kernel's roofline share, and prints its launches by path as the
reading `int8_conv_path_launches` (over the `maps_traced` maps).

The check is the served check with the int8mxu reference in the fp32 reference's place:
every pool request that the window sent is prepared and computed once, and every answer is
compared with it: depth and confidence, at the cost volume's resolution and upsampled, over
the valid (un-padded) region. The numbers compared are the worst map's mean gaps, of depth
(in planes) and of confidence. The largest gap of any pixel is printed as a reading
(`depth_max`, `conf_max`), not compared: in a sound run a link value within an fp32 ulp of a
rounding boundary lands one lattice step from the reference's and the step cascades through
the U-Nets, so one pixel's depth moves by several planes, about as far as in the TF32
control, while the mean gaps of sound runs and of the controls lie far apart (the limits and
their readings: PERF.md section 2).
"""

from __future__ import annotations

from benchmark.check import Gaps
from benchmark.drivers import serve_closed_loop
from benchmark.drivers.serve_closed_loop import _bucket
from benchmark.trace import DeviceTrace

release = serve_closed_loop.release


def setup(run):
    used = run.pipeline_config().act_quant_range
    if run.config["act_quant_range"] != used:
        raise SystemExit(f"the configuration states act_quant_range "
                         f"{run.config['act_quant_range']}, but the program runs at {used}: "
                         f"the harness passes no act_quant_range")
    return serve_closed_loop.setup(run)


class _CountingTrace(DeviceTrace):
    """The run's device trace, which also reads the int8 conv kernel's launches by shape
    over its own window."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def start(self):
        from atvsnet_torch.ops import int8_conv

        int8_conv.reset_launch_counts()
        super().start()

    def stop(self):
        from atvsnet_torch.ops import int8_conv

        super().stop()
        self.run.counters["int8_conv_shapes"] = dict(int8_conv.conv3d_int8_cuda.shape_launches)
        self.run.readings["int8_conv_path_launches"] = dict(
            int8_conv.conv3d_int8_cuda.path_launches)


def window(run, state):
    if run.trace is not None:
        run.trace = _CountingTrace(run)
    serve_closed_loop.window(run, state)


def check(run, state):
    import torch

    from benchmark.reference import int8mxu, model as ref_model, preprocess
    from benchmark.reference.weights import load_weights

    c = run.config
    p = load_weights(run.weights, run.device)
    s = c["sample_scale"]
    depth, conf = Gaps(), Gaps()
    for k in sorted({k for k, _ in state["answers"]}):
        images, cams = state["pool"][k]
        max_h, max_w = _bucket(c, *images[0].shape[:2])
        prep = preprocess.prepare(images, cams, c["view_num"], c["max_d"], max_h, max_w, s)
        ref = int8mxu.forward(p, ref_model.center_images(
            torch.from_numpy(prep["images"]).to(run.device)),
            torch.from_numpy(prep["cams"]).to(run.device), c["max_d"], c["act_quant_range"],
            upsample=True)
        vh, vw = prep["valid_hw"]
        crops = {"depth": (int(vh * s), int(vw * s)), "confidence": (int(vh * s), int(vw * s)),
                 "depth_up": (vh, vw), "confidence_up": (vh, vw)}
        want = {n: ref[n][0, :crops[n][0], :crops[n][1], 0].cpu().numpy() for n in crops}
        del ref
        interval = float(prep["cams"][0, 0, 1, 3, 1])
        for kk, answer in state["answers"]:
            if kk != k:
                continue
            for n, got in answer.items():
                if n.startswith("depth"):
                    depth.add_depth(got, want[n], interval)
                else:
                    conf.add(got, want[n])
    limits = run.traffic["limits"]
    run.checks["depth_mean_planes"] = (depth.worst_mean, limits["depth_mean_planes"])
    run.checks.update(conf.checks(limits, "conf"))
    run.readings.update(depth_max=depth.largest, conf_max=conf.largest,
                        answers_compared=depth.maps // 2,
                        requests_referenced=len({k for k, _ in state["answers"]}))
