"""Whole ETH3D-format scenes through the eval driver and the fusion, back to back: what a
user of reproduce_pc runs.

Set-up renders `scenes` scenes of `images_per_scene` frames (JPEG, full-resolution cams
with a metric depth range, pair lists) from the seed, and warms up with one reference
image of the first scene through run_eval_pc and fuse_scene. The window then runs scene
after scene, cycling through the rendered ones, each through run_eval_pc (its loader and
writer pools, the forward with confidence, the written depth and probability maps) and
then fuse_scene (confidence filter, consistency check, PLY), until `seconds` have passed;
a scene that has begun is finished. maps_per_s is the maps written over the wall seconds
from the window's start to the last scene's cloud. A traced run traces the first scene.

The check: one of the scenes the window ran, drawn from the seed. The reference computes
the depth and confidence of each of its reference images from the scene's files, and its
cloud from those maps by the reference fusion. Every map the window wrote for that scene
is compared, and every cloud the window fused from it.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark import scenes
from benchmark.check import Gaps, cloud_unmatched

THREADS = 8


def _eval_kwargs(run):
    c = run.config
    return dict(view_num=c["view_num"], max_d=c["max_d"], max_w=c["max_w"], max_h=c["max_h"],
                params_path=run.weights, compute_dtype=c["compute_dtype"],
                batch=run.traffic["batch"], device=run.program_device)


def _fuse_kwargs(run):
    c = run.config
    return dict(prob_threshold=c["prob_threshold"], disp_threshold=c["disp_threshold"],
                num_consistent=c["num_consistent"], depth_min=c["fusion_depth_min"],
                depth_max=c["fusion_depth_max"], device=run.program_device)


def setup(run):
    t = run.traffic
    H, W = t["frame"]
    data = os.path.join(run.workdir, "data", "eth3d")
    names = []
    for k in range(t["scenes"]):
        seed = int(run.rng("scene", str(k)).integers(2 ** 31))
        rig = scenes.render_rig(t["images_per_scene"], H, W, seed, num_spheres=t["num_spheres"],
                                depth_min=t["depth_range"][0], depth_max=t["depth_range"][1],
                                threads=THREADS)
        names.append(f"scene_{k}")
        scenes.write_eth3d_scene(os.path.join(data, names[-1]), rig, run.config["max_d"])
    # the warm-up: the first reference image of scene_0 alone, shapes and all
    warm = os.path.join(run.workdir, "warm", "eth3d", "warm")
    os.makedirs(warm)
    for sub in ("images", "cams"):
        os.symlink(os.path.join(data, names[0], sub), os.path.join(warm, sub))
    with open(os.path.join(data, names[0], "pair.txt")) as f:
        lines = f.read().split("\n")
    scenes.write_pairs(warm, [lines[1] + "\n" + lines[2] + "\n"])
    from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
    from atvsnet_torch.fusion.fuse import fuse_scene

    out = os.path.join(run.workdir, "warm_out")
    run_eval_pc(os.path.dirname(os.path.dirname(warm)), out, ["warm"], **_eval_kwargs(run))
    fuse_scene(os.path.join(out, "warm"), **_fuse_kwargs(run))
    return {"data": os.path.dirname(data), "names": names, "done": []}


def window(run, state):
    from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
    from atvsnet_torch.fusion.fuse import fuse_scene
    from atvsnet_torch.ops import softargmin

    n_images = run.traffic["images_per_scene"]
    blocked = 0.0
    t0 = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t0 < run.seconds:
        name = state["names"][k % len(state["names"])]
        out = os.path.join(run.workdir, "out", f"iteration_{k}")
        traced = run.trace is not None and k == 0
        if traced:
            softargmin.reset_launch_counts()
            run.trace.start()
        with run.spans("scene.run_eval_pc"):
            clock = run_eval_pc(state["data"], out, [name], **_eval_kwargs(run))
        with run.spans("scene.fuse_scene"):
            fuse_scene(os.path.join(out, name), **_fuse_kwargs(run))
        if traced:
            run.trace.stop()
            run.maps_traced = n_images
            run.flops_traced = n_images * run.flops_per_map
            run.counters["softargmin_shapes"] = dict(softargmin.softargmin_cuda.shape_launches)
        blocked += clock["blocked"]["load_s"] + clock["blocked"]["write_flush_s"]
        state["done"].append((name, os.path.join(out, name)))
        k += 1
    run.window_s = time.perf_counter() - t0
    run.attempted = k * n_images
    run.values["maps_per_s"] = run.attempted / run.window_s
    run.counters["blocked_s"] = blocked


def release(run, state):
    pass  # run_eval_pc and fuse_scene keep no device state between calls


def check(run, state):
    import cv2
    import torch

    from benchmark.reference import fusion as ref_fusion
    from benchmark.reference import io, model as ref_model, preprocess
    from benchmark.reference.weights import load_weights

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c, s = run.config, run.config["sample_scale"]
    p = load_weights(run.weights, run.device)
    used = sorted({name for name, _ in state["done"]})
    name = used[int(run.rng("check").integers(len(used)))]
    ref = {}
    for views in io.read_pairs(os.path.join(state["data"], "eth3d", name), c["view_num"]):
        prep = preprocess.prepare([cv2.imread(im) for im, _ in views],
                                  [io.read_cam(cm, c["max_d"]) for _, cm in views],
                                  c["view_num"], c["max_d"], c["max_h"], c["max_w"], s)
        out = ref_model.forward(p, ref_model.center_images(
            torch.from_numpy(prep["images"]).to(run.device)),
            torch.from_numpy(prep["cams"]).to(run.device), c["max_d"], upsample=False)
        vh, vw = (int(v * s) for v in prep["valid_hw"])
        depth, conf = (out[k][0, :vh, :vw, 0] for k in ("depth", "confidence"))
        ref[int(os.path.basename(views[0][0]).split(".")[0])] = (
            depth.cpu().numpy(), ref_model.to_metric(depth).cpu().numpy(),
            conf.cpu().numpy(), prep["cams"][0, 0], float(prep["cams"][0, 0, 1, 3, 1]))
    order = sorted(ref)
    cloud = ref_fusion.fuse(
        np.stack([ref_fusion.confidence_filter(ref[i][1], ref[i][2], c["prob_threshold"])
                  for i in order]), np.stack([ref[i][3] for i in order]),
        c["disp_threshold"], c["num_consistent"], c["fusion_depth_min"], c["fusion_depth_max"])
    depth_gaps, conf_gaps, unmatched = Gaps(), Gaps(), 0.0
    for done_name, folder in state["done"]:
        if done_name != name:
            continue
        for i in order:
            stem = os.path.join(folder, "depths_atvsnet", f"{i:08d}")
            depth_gaps.add_depth(io.read_pfm(stem + ".pfm"), ref[i][0], ref[i][4])
            conf_gaps.add(io.read_pfm(stem + "_prob.pfm"), ref[i][2])
        unmatched = max(unmatched, cloud_unmatched(
            io.read_ply(os.path.join(folder, "final3d_model.ply")), cloud))
    limits = run.traffic["limits"]
    run.checks.update(depth_gaps.checks(limits))
    run.checks.update(conf_gaps.checks(limits, "conf"))
    run.checks["cloud_unmatched"] = (unmatched, limits["cloud_unmatched"])
    run.readings.update(conf_max=conf_gaps.largest, maps_compared=depth_gaps.maps,
                        cloud_points=len(cloud))
