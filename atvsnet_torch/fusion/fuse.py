"""Scene-level fusion: probability filtering + consistency fusion + PLY (the port of
atvsnet_tpu/fusion/fuse.py).

Replaces the reference's three-step host pipeline (atvsnet/depth_fusion.py:228-267:
probability_filter -> gipuma format conversion -> fusibile subprocess -> ply copy) with
one in-process pass over the output folder of cli.eval_pointcloud.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Optional

import numpy as np

from atvsnet_torch import resolve_device
from atvsnet_torch.data import image_io
from atvsnet_torch.data.cams import load_cam, projection_matrix
from atvsnet_torch.data.pfm import load_pfm, save_pfm
from atvsnet_torch.fusion.consistency import fuse_depth_maps
from atvsnet_torch.fusion.dmb import fake_normals, write_dmb, write_p_matrix
from atvsnet_torch.fusion.ply import write_ply
from atvsnet_torch.utils import log
from atvsnet_torch.utils.profiling import TRACER


def probability_filter(depth_folder: str, prob_threshold: float) -> None:
    """depth[prob < tau] = 0, written as *_prob_filtered.pfm (depth_fusion.py:183-202)."""
    for img in sorted(glob.glob(os.path.join(depth_folder, "*.jpg"))):
        prefix = os.path.splitext(os.path.basename(img))[0]
        depth_path = os.path.join(depth_folder, prefix + ".pfm")
        prob_path = os.path.join(depth_folder, prefix + "_prob.pfm")
        if not (os.path.exists(depth_path) and os.path.exists(prob_path)):
            continue
        depth = load_pfm(depth_path)
        prob = load_pfm(prob_path)
        depth[prob < prob_threshold] = 0.0
        save_pfm(os.path.join(depth_folder, prefix + "_prob_filtered.pfm"), depth)


def load_scene(depth_folder: str, filtered: bool = True):
    """Read the per-reference-image outputs of cli.eval_pointcloud: depth pfm + jpg + cam txt."""
    depths, images, cams, names = [], [], [], []
    for img_path in sorted(glob.glob(os.path.join(depth_folder, "*.jpg"))):
        prefix = os.path.splitext(os.path.basename(img_path))[0]
        suffix = "_prob_filtered.pfm" if filtered else ".pfm"
        depth_path = os.path.join(depth_folder, prefix + suffix)
        cam_path = os.path.join(depth_folder, prefix + ".txt")
        if not (os.path.exists(depth_path) and os.path.exists(cam_path)):
            continue
        depths.append(load_pfm(depth_path))
        images.append(image_io.imread(img_path))  # BGR
        cams.append(load_cam(cam_path))
        names.append(prefix)
    if not depths:
        raise FileNotFoundError(f"no fused inputs found in {depth_folder}")
    return (
        np.stack(depths),
        np.stack(images),
        np.stack(cams).astype(np.float32),
        names,
    )


def export_gipuma(dense_folder: str, point_folder: str, depth_subdir: str = "depths_atvsnet") -> None:
    """Convert a scene's outputs to the gipuma/fusibile on-disk layout
    (reference depth_fusion.py:113-180): cams/<img>.P projection files,
    images/ copies, and 2333__<prefix>/{disp.dmb, normals.dmb} per view —
    for interop with the original CUDA fusibile binary.
    """
    depth_folder = os.path.join(dense_folder, depth_subdir)
    cam_out = os.path.join(point_folder, "cams")
    img_out = os.path.join(point_folder, "images")
    os.makedirs(cam_out, exist_ok=True)
    os.makedirs(img_out, exist_ok=True)

    for img_path in sorted(glob.glob(os.path.join(depth_folder, "*.jpg"))):
        name = os.path.basename(img_path)
        prefix = os.path.splitext(name)[0]
        cam = load_cam(os.path.join(depth_folder, prefix + ".txt"))
        write_p_matrix(os.path.join(cam_out, name + ".P"), projection_matrix(cam))
        shutil.copy(img_path, os.path.join(img_out, name))

        sub = os.path.join(point_folder, "2333__" + prefix)
        os.makedirs(sub, exist_ok=True)
        filtered = os.path.join(depth_folder, prefix + "_prob_filtered.pfm")
        src = filtered if os.path.exists(filtered) else os.path.join(depth_folder, prefix + ".pfm")
        depth = load_pfm(src)
        write_dmb(os.path.join(sub, "disp.dmb"), depth)
        write_dmb(os.path.join(sub, "normals.dmb"), fake_normals(depth))


def fuse_scene(
    dense_folder: str,
    prob_threshold: float = 0.8,
    disp_threshold: float = 0.01,
    num_consistent: int = 2,
    out_ply: Optional[str] = None,
    depth_subdir: str = "depths_atvsnet",
    depth_min: float = 0.01,
    depth_max: float = 100000.0,
    device=None,
) -> str:
    """End-to-end: filter by confidence, fuse on `device` (CUDA when None), write
    final3d_model.ply.

    Matches the settings wired at reference depth_fusion.py:205-235 (depth_min/max
    match the --depth_min/--depth_max values passed at :210-211,218-219).

    Traced (utils.profiling.TRACER, while a profiler records) as fusion.scene, with
    fusion.filter, fusion.load, fusion.consistency and fusion.ply.
    """
    device = resolve_device(device)  # before any file is written: no CUDA, no half-done scene
    depth_folder = os.path.join(dense_folder, depth_subdir)
    with TRACER.span("fusion.scene"):
        log.info(f"probability filter (tau={prob_threshold}) in {depth_folder}")
        with TRACER.span("fusion.filter"):
            probability_filter(depth_folder, prob_threshold)

        with TRACER.span("fusion.load"):
            depths, images, cams, names = load_scene(depth_folder, filtered=True)
        log.info(f"fusing {len(names)} views ({depths.shape[1]}x{depths.shape[2]})")
        with TRACER.span("fusion.consistency"):
            points, colors_bgr = fuse_depth_maps(
                depths, images, cams, disp_thresh=disp_threshold, num_consistent=num_consistent,
                depth_min=depth_min, depth_max=depth_max, device=device,
            )
        colors_rgb = colors_bgr[:, ::-1]  # cv2 loads BGR; PLY stores RGB (displayUtils.h:85-88)

        out_ply = out_ply or os.path.join(dense_folder, "final3d_model.ply")
        with TRACER.span("fusion.ply"):
            write_ply(out_ply, points, colors_rgb)
    log.info(f"{points.shape[0]} points -> {out_ply}")
    return out_ply
