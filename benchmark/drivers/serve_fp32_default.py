"""The closed-loop served traffic of serve_closed_loop under fp32_precision="default",
checked against the plain one-pass reference (benchmark/reference/fp32_default.py).

Set-up, the window and the release are serve_closed_loop's. A traced window also counts the
pass leaves' launches by shape (ops.fp32_passes: `pass_conv`, `pass_conv_transpose` and
`pass_matmul` `.shape_launches`, from zero at the trace's start) into
run.counters["pass_shapes"] when the trace stops, for the leaves' roofline share, and prints
their launches by leaf as the reading `pass_launches` (over the `maps_traced` maps). A
program without those counts leaves both empty.

The check is the served check with the one-pass reference in the fp32 reference's place:
every pool request that the window sent is prepared and computed once, and every answer is
compared with it: depth and confidence, at the cost volume's resolution and upsampled, over
the valid (un-padded) region. The numbers compared are the worst map's mean gaps, of depth
(in planes) and of confidence. The largest gap of any pixel is printed as a reading
(`depth_max`, `conf_max`), not compared: where fp32 noise moves a value across a bf16
rounding tie, the next leaf's operand moves by a bf16 step, and the step cascades through
the U-Nets, so a few pixels move far in a sound run (the limits and their readings: PERF.md
section 2).
"""

from __future__ import annotations

from benchmark.check import Gaps
from benchmark.drivers import serve_closed_loop
from benchmark.drivers.serve_closed_loop import _bucket
from benchmark.trace import DeviceTrace

setup = serve_closed_loop.setup
release = serve_closed_loop.release
LEAVES = ("pass_conv", "pass_conv_transpose", "pass_matmul")


class _CountingTrace(DeviceTrace):
    """The run's device trace, which also reads the pass leaves' launches by shape over its
    own window."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def start(self):
        from atvsnet_torch.ops import fp32_passes

        reset = getattr(fp32_passes, "reset_launch_counts", None)
        if reset is not None:
            reset()
        super().start()

    def stop(self):
        from atvsnet_torch.ops import fp32_passes

        super().stop()
        shapes, launches = {}, {}
        for name in LEAVES:
            leaf = getattr(fp32_passes, name)
            shapes.update(getattr(leaf, "shape_launches", {}))
            launches[name] = getattr(leaf, "launches", 0)
        self.run.counters["pass_shapes"] = shapes
        self.run.readings["pass_launches"] = launches


def window(run, state):
    if run.trace is not None:
        run.trace = _CountingTrace(run)
    serve_closed_loop.window(run, state)


def check(run, state):
    import torch

    from benchmark.reference import fp32_default, model as ref_model, preprocess
    from benchmark.reference.weights import load_weights

    c = run.config
    p = load_weights(run.weights, run.device)
    s = c["sample_scale"]
    depth, conf = Gaps(), Gaps()
    for k in sorted({k for k, _ in state["answers"]}):
        images, cams = state["pool"][k]
        max_h, max_w = _bucket(c, *images[0].shape[:2])
        prep = preprocess.prepare(images, cams, c["view_num"], c["max_d"], max_h, max_w, s)
        ref = fp32_default.forward(p, ref_model.center_images(
            torch.from_numpy(prep["images"]).to(run.device)),
            torch.from_numpy(prep["cams"]).to(run.device), c["max_d"], upsample=True)
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
