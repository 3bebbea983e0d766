"""One caller in a closed loop on a long-lived DepthEstimator: each request is
view_num uint8 frames with their cams; the next goes in when the last has come back.

Set-up renders `rigs` rigs of `views_per_rig` frames at the largest frame size of the
mix, and draws a pool of `pool` requests from them: a reference view, its nearest views,
and a frame size drawn from the mix's ranges, cut from the rig's frames at a drawn offset
(the principal point moves with the cut). The estimator has the configuration's buckets;
two requests of the pool warm up the shapes they route to. The window sends the pool's
requests in a seeded order, cycling, for `seconds`. Latency is the wall time around
predict; served_maps_per_s the requests completed over the window's seconds. A traced run traces
the requests that begin in the first `trace_seconds`.

The check: the reference prepares and computes every pool request that the window sent
once, and every answer the window returned is compared with it: depth and confidence, at
the cost volume's resolution and upsampled, over the valid (un-padded) region.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import scenes
from benchmark.check import Gaps
from benchmark.stats import percentile

THREADS = 8


def _pool(run):
    t, c = run.traffic, run.config
    (h_lo, h_hi), (w_lo, w_hi) = t["frame_h"], t["frame_w"]
    rigs = []
    for k in range(t["rigs"]):
        seed = int(run.rng("rig", str(k)).integers(2 ** 31))
        rig = scenes.render_rig(t["views_per_rig"], h_hi, w_hi, seed,
                                num_spheres=t["num_spheres"], depth_min=t["depth_range"][0],
                                depth_max=t["depth_range"][1], threads=THREADS)
        rigs.append((scenes.frames_uint8(rig), scenes.rig_cams(rig, c["max_d"])))
    rng = run.rng("pool")
    pool = []
    for _ in range(t["pool"]):
        frames, cams = rigs[int(rng.integers(len(rigs)))]
        n = frames.shape[0]
        ref = int(rng.integers(n))
        views = sorted(range(n), key=lambda v: (abs(v - ref), v))[:c["view_num"]]
        h, w = int(rng.integers(h_lo, h_hi + 1)), int(rng.integers(w_lo, w_hi + 1))
        top, left = int(rng.integers(h_hi - h + 1)), int(rng.integers(w_hi - w + 1))
        req_cams = []
        for v in views:
            cam = cams[v].copy()
            cam[1, 0, 2] -= left
            cam[1, 1, 2] -= top
            req_cams.append(cam)
        pool.append(([np.ascontiguousarray(frames[v, top:top + h, left:left + w])
                      for v in views], req_cams))
    return pool


def _bucket(config, h, w):
    """The bucket DepthEstimator routes an (h, w) request to: the smallest that fits, else
    the largest."""
    buckets = [(config["max_h"], config["max_w"])] + [tuple(b) for b in config["buckets"]]
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    return (min(fitting, key=lambda b: b[0] * b[1]) if fitting
            else max(buckets, key=lambda b: b[0] * b[1]))


def setup(run):
    from atvsnet_torch.serving import DepthEstimator

    pool = _pool(run)
    est = DepthEstimator(run.pipeline_config(), params_path=run.weights,
                         with_confidence=run.config["with_confidence"],
                         device=run.program_device)
    for max_h, max_w in run.config["buckets"]:
        est.add_bucket(max_h=max_h, max_w=max_w)
    for images, cams in pool[:2]:
        est.predict(images, cams)
    return {"est": est, "pool": pool, "answers": []}


def window(run, state):
    from atvsnet_torch.ops import softargmin

    est, pool = state["est"], state["pool"]
    flops_of = [run.flops_of(*_bucket(run.config, *images[0].shape[:2])) for images, _ in pool]
    order = run.rng("order").permutation(len(pool))
    latency, host = [], []
    trace_until = None
    if run.trace is not None:
        softargmin.reset_launch_counts()
        run.trace.start()
        trace_until = time.perf_counter() + run.traffic["trace_seconds"]
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        k = int(order[i % len(order)])
        images, cams = pool[k]
        with run.spans("request.predict"):
            a = time.perf_counter()
            out = est.predict(images, cams)
            b = time.perf_counter()
        latency.append(b - a)
        if trace_until is not None:
            run.flops_traced += flops_of[k]
        host.append(b - a - out["runtime_s"])
        state["answers"].append((k, {n: np.array(out[n]) for n in
                                     ("depth", "depth_up", "confidence", "confidence_up")
                                     if n in out}))
        i += 1
        if trace_until is not None and b >= trace_until:
            run.trace.stop()
            run.maps_traced = i
            run.counters["softargmin_shapes"] = dict(softargmin.softargmin_cuda.shape_launches)
            trace_until = None
    if trace_until is not None:
        run.trace.stop()
        run.maps_traced = i
        run.counters["softargmin_shapes"] = dict(softargmin.softargmin_cuda.shape_launches)
    run.window_s = time.perf_counter() - t0
    run.attempted = i
    run.values["served_maps_per_s"] = i / run.window_s
    run.values["latency_p95_ms"] = percentile(latency, 95) * 1e3
    run.counters["host_s"] = host
    run.readings.update(requests=i, latency_ms={
        q: percentile(latency, q) * 1e3 for q in (0, 50, 90, 95, 99, 100)},
        runtime_ms_median=percentile([a - h for a, h in zip(latency, host)], 50) * 1e3)


def release(run, state):
    state.pop("est", None)


def check(run, state):
    import torch

    from benchmark.reference import model as ref_model, preprocess
    from benchmark.reference.weights import load_weights

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c = run.config
    p = load_weights(run.weights, run.device)
    s = c["sample_scale"]
    depth, conf = Gaps(), Gaps()
    for k in sorted({k for k, _ in state["answers"]}):
        images, cams = state["pool"][k]
        max_h, max_w = _bucket(c, *images[0].shape[:2])
        prep = preprocess.prepare(images, cams, c["view_num"], c["max_d"], max_h, max_w, s)
        ref = ref_model.forward(p, ref_model.center_images(
            torch.from_numpy(prep["images"]).to(run.device)),
            torch.from_numpy(prep["cams"]).to(run.device), c["max_d"], upsample=True)
        vh, vw = prep["valid_hw"]
        crops = {"depth": (int(vh * s), int(vw * s)), "confidence": (int(vh * s), int(vw * s)),
                 "depth_up": (vh, vw), "confidence_up": (vh, vw)}
        want = {n: ref[n][0, :crops[n][0], :crops[n][1], 0].cpu().numpy() for n in crops}
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
    run.checks.update(depth.checks(limits))
    run.checks.update(conf.checks(limits, "conf"))
    run.readings.update(conf_max=conf.largest, answers_compared=depth.maps // 2,
                        requests_referenced=len({k for k, _ in state["answers"]}))
