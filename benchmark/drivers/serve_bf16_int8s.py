"""The closed-loop served traffic of serve_closed_loop in the JAX package's speed mode,
compute_dtype="bfloat16" with act_quant="int8s" and warp_quant="int8", checked against the
plain reference of the mode (benchmark/reference/bf16_int8s.py).

Set-up, the window and the release are serve_closed_loop's. Set-up first holds the
configuration's `act_quant_range` to the value the program will use (the harness's
`pipeline_config` does not pass it: PipelineConfig's default applies). A traced window also
counts the bf16 conv leaves' launches by shape (nn.layers.bf16_conv.shape_launches, from
zero at the trace's start) into run.counters["bf16_conv_shapes"] when the trace stops, for
the leaves' roofline share, and prints their launches by kind as the reading
`bf16_conv_launches` (over the `maps_traced` maps). A program without those counts leaves
both empty.

The check is the served check with the mode's reference in the fp32 reference's place:
every pool request that the window sent is prepared and computed once, and every answer is
compared with it: depth and confidence, at the cost volume's resolution and upsampled, over
the valid (un-padded) region. The numbers compared are the worst map's mean gaps, of depth
(in planes) and of confidence. The largest gap of any pixel is printed as a reading
(`depth_max`, `conf_max`), not compared: where fp32 noise moves a value across a bf16
rounding tie or a link's lattice boundary, the next leaf's operand moves by a step, and the
step cascades through the U-Nets, so a few pixels move far in a sound run (the limits and
their readings: PERF.md section 2).
"""

from __future__ import annotations

from benchmark.check import Gaps
from benchmark.drivers import serve_closed_loop
from benchmark.drivers.serve_closed_loop import _bucket
from benchmark.trace import DeviceTrace

release = serve_closed_loop.release
KINDS = ("conv2d", "conv3d", "conv_transpose")


def setup(run):
    used = run.pipeline_config().act_quant_range
    if run.config["act_quant_range"] != used:
        raise SystemExit(f"the configuration states act_quant_range "
                         f"{run.config['act_quant_range']}, but the program runs at {used}: "
                         f"the harness passes no act_quant_range")
    return serve_closed_loop.setup(run)


class _CountingTrace(DeviceTrace):
    """The run's device trace, which also reads the bf16 conv leaves' launches by shape over
    its own window."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def start(self):
        from atvsnet_torch.nn import layers

        reset = getattr(layers, "reset_launch_counts", None)
        if reset is not None:
            reset()
        super().start()

    def stop(self):
        from atvsnet_torch.nn import layers

        super().stop()
        leaf = getattr(layers, "bf16_conv", None)
        self.run.counters["bf16_conv_shapes"] = dict(getattr(leaf, "shape_launches", {}))
        self.run.readings["bf16_conv_launches"] = dict(getattr(leaf, "path_launches", {}))


def window(run, state):
    if run.trace is not None:
        run.trace = _CountingTrace(run)
    serve_closed_loop.window(run, state)


def check(run, state):
    import torch

    from benchmark.reference import bf16_int8s, model as ref_model, preprocess
    from benchmark.reference.weights import load_weights

    c = run.config
    p = load_weights(run.weights, run.device)
    s = c["sample_scale"]
    depth, conf = Gaps(), Gaps()
    for k in sorted({k for k, _ in state["answers"]}):
        images, cams = state["pool"][k]
        max_h, max_w = _bucket(c, *images[0].shape[:2])
        prep = preprocess.prepare(images, cams, c["view_num"], c["max_d"], max_h, max_w, s)
        ref = bf16_int8s.forward(p, ref_model.center_images(
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


def reference_forward(weights_path: str, device, bits: int):
    """The mode's reference with its roundings at `bits` significant bits, in the served
    forward's place (atvsnet_torch.serving.multi_view_forward's signature): at bits < 8 a
    precision below the configuration's, the check's control (a)."""
    import torch

    from benchmark.reference import bf16_int8s
    from benchmark.reference.weights import load_weights

    p = load_weights(weights_path, device)

    def forward(model, images, cams, cfg, out_prob_map=False, upsample=True):
        return bf16_int8s.forward(p, images.to(torch.float32),
                                  torch.as_tensor(cams, device=images.device), cfg.max_d,
                                  cfg.act_quant_range, upsample=upsample, bits=bits)

    return forward
