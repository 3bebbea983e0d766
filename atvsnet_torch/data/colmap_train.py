"""ETH3D/COLMAP training samples (reference preprocess_colmap.py:389-510); the port of
atvsnet_tpu/data/colmap_train.py.

Builds [ref, neighbors..., gt-depth] samples from COLMAP sparse text models, loads them
into training batches (images + assembled sweep cameras + sweep-space gt), and can emit
them to disk in the MVSNet training layout. Conventions as in the JAX package: per-image
disparity ranges from the sparse points, overridden by the gt depth map when it has
valid pixels; the photometric group augmentation; the crop and scale rules of
preprocess.py:63-92. Every codec call goes through data.image_io.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from atvsnet_torch.data import image_io
from atvsnet_torch.data.augment import augment_image_group
from atvsnet_torch.data.cams import write_cam
from atvsnet_torch.data.colmap import (
    ColmapSparse,
    colmap_cam_to_mvsnet,
    set_depth_range_from_depthmap,
)
from atvsnet_torch.data.pfm import load_pfm, save_pfm
from atvsnet_torch.data.preprocess import crop_mvs_input, scale_mvs_input
from atvsnet_torch.geometry.cameras import scale_camera_np

# reference preprocess_colmap.py:404-406
ETH3D_TRAINING_SCENES = ["delivery_area", "electro", "forest", "playground", "terrains"]


@dataclasses.dataclass(frozen=True)
class Eth3dSample:
    scene_idx: int
    ref_id: int
    view_ids: Tuple[int, ...]
    gt_depth_path: str
    augment_index: int


def eth3d_neighbor_ids(sparse: ColmapSparse, ref_id: int, view_num: int) -> List[int]:
    """Neighbor ids with the reference's fallback and ref padding
    (preprocess_colmap.py:440-460): when the shared-point neighbor list is empty,
    probe index-adjacent ids (ref+1+ni, else ref-1-ni, else ref itself); always pad
    with the reference id up to view_num, then keep the first view_num-1."""
    neigh = list(sparse.images[ref_id].neighbor_list or [])
    if not neigh:
        for ni in range(view_num):
            if (ref_id + 1 + ni) in sparse.images:
                neigh.append(ref_id + 1 + ni)
            elif (ref_id - 1 - ni) in sparse.images:
                neigh.append(ref_id - 1 - ni)
            else:
                neigh.append(ref_id)
    while len(neigh) < view_num:
        neigh.append(ref_id)
    return neigh[: view_num - 1]


def eth3d_training_samples(
    data_folder: str,
    gt_folder: str,
    view_num: int,
    augment_number: int = 1,
    mode: str = "training",
    scenes: Optional[Sequence[str]] = None,
    image_subdir: str = "images_undistorted",
    sparse_subdir: str = "rig_calibration",
    gt_subdir_fmt: str = "{scene}_rig_depth/{scene}/ground_truth_depth_undistorted",
):
    """The ETH3D training sample list (preprocess_colmap.py:389-510).

    Returns (samples: List[Eth3dSample], sparses: List[ColmapSparse]). The reference's
    training/validation split is [all scenes]/[] (preprocess_colmap.py:405-407), so
    mode='validation' yields no samples unless `scenes` is given.
    """
    if scenes is None:
        scenes = ETH3D_TRAINING_SCENES if mode == "training" else []
    samples: List[Eth3dSample] = []
    sparses: List[ColmapSparse] = []
    for scene_idx, scene in enumerate(scenes):
        image_folder = os.path.join(data_folder, scene, image_subdir)
        sparse_folder = os.path.join(data_folder, scene, sparse_subdir)
        depth_folder = os.path.join(gt_folder, gt_subdir_fmt.format(scene=scene))
        sparse = ColmapSparse(sparse_folder, image_folder, num_neighbors=view_num - 1)
        sparses.append(sparse)
        for ref_id, img in sorted(sparse.images.items()):
            view_ids = eth3d_neighbor_ids(sparse, ref_id, view_num)
            gt_path = os.path.join(depth_folder, img.filename)
            for aug in range(augment_number):
                samples.append(Eth3dSample(scene_idx, ref_id, tuple(view_ids), gt_path, aug))
    return samples, sparses


def load_gt_depth(path: str, height: int, width: int) -> np.ndarray:
    """A gt depth map: ETH3D raw float32 (H*W little-endian values, NaN/inf = missing),
    or .pfm / .exr by extension. Invalid values become 0."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        depth = load_pfm(path)
    elif ext == ".exr":
        depth = image_io.imread_depth(path)
    else:
        raw = np.fromfile(path, np.float32)
        if raw.size != height * width:
            raise ValueError(f"{path}: {raw.size} values, expected {height}x{width}")
        depth = raw.reshape(height, width)
    depth = np.asarray(depth, np.float32)
    return np.where(np.isfinite(depth) & (depth > 0), depth, 0.0)


def _sweep_range_from_depth(cams: np.ndarray, depth: np.ndarray, max_d: int,
                            inverse_depth: bool) -> np.ndarray:
    src = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-10), 0.0) if inverse_depth else depth
    return set_depth_range_from_depthmap(cams, src, max_d)


def load_colmap_training_sample(
    sparse: ColmapSparse,
    ref_id: int,
    view_ids: Sequence[int],
    gt_depth_path: str,
    max_d: int = 128,
    max_h: int = 480,
    max_w: int = 896,
    scale: float = 1.0,
    sample_scale: float = 0.25,
    inverse_depth: bool = True,
    augment_rng=None,
):
    """One [ref, views...] COLMAP sample -> training batch.

    Returns dict(images (1,N,H,W,3) normalized, cams (1,N,2,4,4) at cost-volume scale,
    depth_gt (1,h,w,1) sweep-space). The sweep range comes from the gt depth map when it
    has valid pixels, else from the sparse-point disparity estimates.
    """
    ids = [ref_id] + list(view_ids)
    images = [image_io.imread(sparse.images[i].filepath) for i in ids]
    H, W = images[0].shape[:2]
    depth = load_gt_depth(gt_depth_path, H, W)

    cams = [colmap_cam_to_mvsnet(sparse, i, max_d, inverse_depth) for i in ids]
    if scale != 1.0:
        images, cams, depth = scale_mvs_input(images, cams, scale, depth_image=depth)
    images, cams, depth = crop_mvs_input(images, cams, max_h, max_w, depth_image=depth)

    cams = np.stack(cams)
    if (depth > 0).any():
        cams = _sweep_range_from_depth(cams, depth, max_d, inverse_depth)

    images = augment_image_group(images, rng=augment_rng)
    cams = np.stack([scale_camera_np(c, sample_scale) for c in cams])

    h = int(depth.shape[0] * sample_scale)
    w = int(depth.shape[1] * sample_scale)
    gt_small = image_io.resize_to(depth, w, h, "nearest")
    if inverse_depth:
        gt_small = np.where(gt_small > 0, 1.0 / np.maximum(gt_small, 1e-10), 0.0)

    return {
        "images": np.stack(images)[None].astype(np.float32),
        "cams": cams[None].astype(np.float32),
        "depth_gt": gt_small[None, ..., None].astype(np.float32),
    }


def emit_training_samples(
    samples: Sequence[Eth3dSample],
    sparses: Sequence[ColmapSparse],
    out_dir: str,
    max_d: int = 128,
    max_h: int = 480,
    max_w: int = 896,
    inverse_depth: bool = True,
    seed: int = 0,
) -> int:
    """Write the samples to disk in the MVSNet training layout
    (<out>/<idx:08d>/{view_j.jpg, cam_j.txt, depth.pfm}). Images are stored
    un-normalized; augmentation is applied at load time. Samples with an unreadable image
    are skipped; returns the number written."""
    count = 0
    for idx, s in enumerate(samples):
        sparse = sparses[s.scene_idx]
        ids = [s.ref_id] + list(s.view_ids)
        try:
            images = [image_io.imread(sparse.images[i].filepath) for i in ids]
        except FileNotFoundError:
            continue
        H, W = images[0].shape[:2]
        depth = load_gt_depth(s.gt_depth_path, H, W)
        cams = [colmap_cam_to_mvsnet(sparse, i, max_d, inverse_depth) for i in ids]
        images, cams, depth = crop_mvs_input(images, cams, max_h, max_w, depth_image=depth)
        cams = np.stack(cams)
        if (depth > 0).any():
            cams = _sweep_range_from_depth(cams, depth, max_d, inverse_depth)
        sdir = os.path.join(out_dir, f"{idx:08d}")
        os.makedirs(sdir, exist_ok=True)
        for j, (im, cam) in enumerate(zip(images, cams)):
            image_io.imwrite(os.path.join(sdir, f"view_{j}.jpg"), im)
            write_cam(os.path.join(sdir, f"cam_{j}.txt"), cam)
        save_pfm(os.path.join(sdir, "depth.pfm"), depth.astype(np.float32))
        count += 1
    return count
