"""Host-side input preparation (numpy), reference atvsnet/preprocess.py; the port of
atvsnet_tpu/data/preprocess.py with the same policy and the same results.

Covers: per-image variance normalization, image/camera rescaling, center-crop to
32-multiples with principal-point shift, inverse-depth sweep conversion, and the
adaptive-scaling policy of the eval script (eval_pointcloud.py:124-207).

Only decoding files and resizing by a factor other than 1 need an image codec, and
both go through data.image_io; everything else here is numpy.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np

from atvsnet_torch.data import image_io
from atvsnet_torch.data.cams import load_cam
from atvsnet_torch.data.pfm import load_pfm
from atvsnet_torch.geometry.cameras import scale_camera_np


def center_image(img: np.ndarray) -> np.ndarray:
    """Per-image, per-channel variance normalization (preprocess.py:20-25).

    Population mean and std accumulate in float64 and are rounded to float32 before the
    float32 division, which is what cv2.meanStdDev gives the JAX package's version.
    """
    mean = np.mean(img, axis=(0, 1), keepdims=True, dtype=np.float64).astype(np.float32)
    std = np.std(img, axis=(0, 1), keepdims=True, dtype=np.float64).astype(np.float32)
    return (img.astype(np.float32) - mean) / (std + 1e-8)


def scale_image(image: np.ndarray, scale: float, interpolation: str = "linear") -> np.ndarray:
    """Resize by `scale`. At scale 1.0 the image comes back as it is (cv2.resize at
    fx = fy = 1 is the identity), so inputs of the bucket's size need no codec."""
    if scale == 1.0:
        return image
    return image_io.resize(image, scale, interpolation)


def scale_mvs_input(images: list, cams: list, scale: float = 1.0, depth_image=None):
    images = [scale_image(im, scale) for im in images]
    cams = [scale_camera_np(c, scale) for c in cams]
    if depth_image is None:
        return images, cams
    return images, cams, scale_image(depth_image, scale, "nearest")


def crop_mvs_input(
    images: list,
    cams: list,
    max_h: int,
    max_w: int,
    depth_image=None,
    base_image_size: int = 32,
):
    """Center-crop to <= (max_h, max_w) and to multiples of base_image_size,
    shifting principal points accordingly (preprocess.py:63-92)."""
    out_images, out_cams = [], []
    start_h = start_w = finish_h = finish_w = 0
    for image, cam in zip(images, cams):
        h, w = image.shape[:2]
        new_h = max_h if h > max_h else int(math.ceil(h / base_image_size) * base_image_size)
        new_w = max_w if w > max_w else int(math.ceil(w / base_image_size) * base_image_size)
        # sizes below max and not multiples of 32 round DOWN: the reference's
        # ceil (preprocess.py:74-78) makes new_h > h, whose negative crop start
        # silently yields a tiny corrupt slice — deliberate divergence from a
        # broken-and-unexercised reference path (e.g. 403-px colmap training
        # crops at small scales)
        if new_h > h:
            new_h = (h // base_image_size) * base_image_size
        if new_w > w:
            new_w = (w // base_image_size) * base_image_size
        if new_h == 0 or new_w == 0:
            raise ValueError(
                f"image {h}x{w} is smaller than base_image_size={base_image_size}"
            )
        # ceil'd center start, exactly like reference preprocess.py:80-81 (one
        # pixel HIGHER than floor division when the crop margin is odd)
        start_h = int(math.ceil((h - new_h) / 2))
        start_w = int(math.ceil((w - new_w) / 2))
        finish_h = start_h + new_h
        finish_w = start_w + new_w
        out_images.append(image[start_h:finish_h, start_w:finish_w])
        cam = np.copy(cam)
        cam[1][0][2] -= start_w
        cam[1][1][2] -= start_h
        out_cams.append(cam)
    if depth_image is not None:
        return out_images, out_cams, depth_image[start_h:finish_h, start_w:finish_w]
    return out_images, out_cams


def pad_mvs_input(images: list, target_h: int, target_w: int) -> list:
    """Edge-replicate-pad each view at the bottom/right up to (target_h, target_w).

    Bottom/right padding leaves the principal point (and therefore the cams) intact;
    edge replication keeps the normalization statistics close to the real image. The
    caller tracks the valid region and crops the outputs back.
    """
    out = []
    for im in images:
        h, w = im.shape[:2]
        pad = ((0, max(0, target_h - h)), (0, max(0, target_w - w))) + ((0, 0),) * (im.ndim - 2)
        out.append(np.pad(im, pad, mode="edge") if (h < target_h or w < target_w) else im)
    return out


def mask_depth_image(depth_image: np.ndarray, min_depth: float, max_depth: float) -> np.ndarray:
    """Zero out-of-range depths (preprocess.py:94-100)."""
    out = np.where(depth_image <= min_depth, 0.0, depth_image)
    out = np.where(out > max_depth, 0.0, out)
    return np.expand_dims(out, 2) if out.ndim == 2 else out


def to_inverse_depth_range(cam: np.ndarray, max_d: int) -> np.ndarray:
    """Convert the cam depth row from metric to an inverse-depth sweep.

    Reference eval_pointcloud.py:153-169: disp in [1/depth_max, 1/depth_min] split
    into max_d equal steps.
    """
    cam = np.copy(cam)
    depth_min = cam[1][3][0]
    depth_interval = cam[1][3][1]
    if cam[1][3][2] > 0 and cam[1][3][3] > 0:
        num_d = cam[1][3][2]
        depth_max = cam[1][3][3]
    else:
        num_d = max_d
        depth_max = depth_min + float(num_d - 1) * depth_interval
    disp_min = 1.0 / depth_max
    disp_max = 1.0 / depth_min
    cam[1][3][0] = disp_min
    cam[1][3][1] = (disp_max - disp_min) / max_d
    cam[1][3][2] = max_d
    cam[1][3][3] = disp_max
    return cam


def find_gt_depth_path(ref_image_path: str) -> str | None:
    """Locate a GT depth map for a reference image (eval_pointcloud.py:171-178).

    The reference's chain: a sidecar `<stem>.txt` next to the image holds the real
    filename; that name resolved under the sibling `depths/` folder (images/ ->
    depths/) with an `.exr` extension is the GT. Also accepts `.pfm` (this repo's
    native float format) when no EXR exists.
    """
    stem_txt = os.path.splitext(ref_image_path)[0] + ".txt"
    if not os.path.exists(stem_txt):
        return None
    with open(stem_txt) as f:
        filename = f.readline().strip()
    named = os.path.join(os.path.dirname(ref_image_path), filename)
    depth_base = os.path.splitext(named.replace(os.sep + "images" + os.sep,
                                                os.sep + "depths" + os.sep))[0]
    for ext in (".exr", ".pfm"):
        if os.path.exists(depth_base + ext):
            return depth_base + ext
    return None


def read_gt_depth(path: str) -> np.ndarray:
    """Read a GT depth map (.exr or .pfm) as float32 (H, W)."""
    if path.endswith(".pfm"):
        return np.asarray(load_pfm(path), np.float32)
    from atvsnet_torch.data.mvs_syn import _read_exr_depth

    return _read_exr_depth(path)


def sweep_range_from_gt(
    cams: list, depth_gt: np.ndarray, max_d: int, inverse_depth: bool = True
) -> list:
    """Override every view's sweep row from the GT depth range
    (reference eval_pointcloud.py:179-193, masking-order quirks included).

    The reference computes disp_max BEFORE masking non-positives and disp_min after,
    so the range is [min positive (inverse-)depth, max (inverse-)depth].
    """
    d = depth_gt.astype(np.float32).copy()
    if inverse_depth:
        d[d <= 0.0] = np.inf
        d = 1.0 / d
    disp_max = float(np.max(d))
    d[d <= 0.0] = np.inf
    disp_min = float(np.min(d))
    disp_interval = (disp_max - disp_min) / max_d
    out = []
    for cam in cams:
        cam = np.copy(cam)
        cam[1][3][0] = disp_min
        cam[1][3][1] = disp_interval
        cam[1][3][2] = max_d
        cam[1][3][3] = disp_max
        out.append(cam)
    return out


def load_mvs_sample(
    paths: Sequence[str],
    view_num: int,
    max_d: int = 128,
    max_h: int = 480,
    max_w: int = 896,
    sample_scale: float = 0.25,
    inverse_depth: bool = True,
    adaptive_scaling: bool = True,
    base_image_size: int = 32,
    gt_range: bool = False,
    center: bool = True,
):
    """Load one [ref, views...] sample as the eval script does (eval_pointcloud.py:96-209).

    paths alternates image/cam files; returns dict with
      images        (1, N, H, W, 3) float32 variance-normalized
      images_raw    (1, N, H, W, 3) uint8/float cropped raw images (full res)
      cams          (1, N, 2, 4, 4) float32, intrinsics at sample_scale
      index         ref image index (int)

    gt_range=True additionally looks for a GT depth map next to the reference image
    (find_gt_depth_path) and, when found, overrides the sweep range from it
    (reference eval_pointcloud.py:171-193).
    """
    n_available = len(paths) // 2
    images, cams = [], []
    for v in range(min(view_num, n_available)):
        images.append(image_io.imread(paths[2 * v]))
        cams.append(load_cam(paths[2 * v + 1], max_d=max_d))

    gt_depth = None
    if gt_range:
        gt_path = find_gt_depth_path(paths[0])
        if gt_path is not None:
            gt_depth = read_gt_depth(gt_path)

    index = int(os.path.splitext(os.path.basename(paths[0]))[0])
    out = prepare_mvs_sample(
        images, cams, view_num, max_d=max_d, max_h=max_h, max_w=max_w,
        sample_scale=sample_scale, inverse_depth=inverse_depth,
        adaptive_scaling=adaptive_scaling, base_image_size=base_image_size,
        gt_depth=gt_depth, center=center,
    )
    out["index"] = index
    return out


def prepare_mvs_sample(
    images: list,
    cams: list,
    view_num: int,
    max_d: int = 128,
    max_h: int = 480,
    max_w: int = 896,
    sample_scale: float = 0.25,
    inverse_depth: bool = True,
    adaptive_scaling: bool = True,
    base_image_size: int = 32,
    gt_depth: np.ndarray | None = None,
    center: bool = True,
):
    """In-memory version of load_mvs_sample: [ref, views...] arrays + (2,4,4) cams.

    Applies the eval script's full preparation policy (eval_pointcloud.py:96-209):
    view padding with the reference, adaptive down-scaling into the (max_h, max_w)
    bucket, pad-and-mask for smaller inputs, center-crop to base_image_size
    multiples with principal-point shift, per-image variance normalization,
    inverse-depth sweep conversion, and cost-volume-scale intrinsics.

    gt_depth: optional GT depth map for the reference view; when given, the sweep
    range is overridden from it AFTER the inverse-depth conversion, exactly where
    the reference applies its override (eval_pointcloud.py:171-193).

    center=False skips the host-side variance normalization: "images" is then the raw
    uint8 stack and the caller must normalize on the device
    (models.atvsnet.center_images) before the forward.
    """
    # truncate extra views (same policy as load_mvs_sample's min(view_num, n)) so
    # callers feeding more neighbors than the bucket get the eval script's behavior, not a
    # deep shape error inside the forward
    images = list(images)[:view_num]
    cams = [np.copy(c) for c in cams[:view_num]]
    # pad with the reference view when fewer neighbors exist (eval_pointcloud.py:115-121)
    while len(images) < view_num:
        images.append(images[0])
        cams.append(np.copy(cams[0]))
    for cam in cams:
        if cam[1][3][2] == 0:
            cam[1][3][2] = max_d

    resize_scale = 1.0
    padded = False
    if adaptive_scaling:
        h_scale = max(float(max_h) / im.shape[0] for im in images)
        w_scale = max(float(max_w) / im.shape[1] for im in images)
        if h_scale > 1 or w_scale > 1:
            # images smaller than the (max_h, max_w) bucket: the reference exits here
            # (eval_pointcloud.py:136-139); instead keep scale 1 and pad-and-mask
            # below so small scenes still run through the one compiled bucket shape
            padded = True
        else:
            resize_scale = max(h_scale, w_scale)
    images, cams = scale_mvs_input(images, cams, scale=resize_scale)
    valid_h = min(images[0].shape[0], max_h)
    valid_w = min(images[0].shape[1], max_w)
    if padded:
        images = pad_mvs_input(images, max_h, max_w)
    images, cams = crop_mvs_input(images, cams, max_h, max_w, base_image_size=base_image_size)

    if inverse_depth:
        cams = [to_inverse_depth_range(c, max_d) for c in cams]
    if gt_depth is not None:
        cams = sweep_range_from_gt(cams, gt_depth, max_d, inverse_depth=inverse_depth)
    cams = [scale_camera_np(c, sample_scale) for c in cams]

    raw = np.expand_dims(np.stack(images), 0)
    if center:
        stacked = np.stack([center_image(im) for im in images])
        if stacked.dtype != np.float32:  # avoid a gratuitous 25MB copy when already f32
            stacked = stacked.astype(np.float32)
        images_out = np.expand_dims(stacked, 0)
    else:
        # the caller normalizes on the device (models.atvsnet.center_images): uint8 is
        # a quarter of the bytes to upload, and the host makes no fp32 pass
        images_out = raw
    return {
        "images": images_out,
        "images_raw": raw,
        "cams": np.expand_dims(np.stack(cams), 0).astype(np.float32),
        # valid (un-padded) region of the reference view at FULL resolution;
        # equals the bucket unless the inputs were smaller and got padded
        "valid_hw": (valid_h, valid_w),
    }


def load_example_dir(data_root: str, view_num: int):
    """Load an example/{i} directory: {v}.jpg + {v}_cam.npy [+ 0_gt.npy].

    Reference example.py:326-342 — images are fed RAW (no normalization) and the
    bundled cam npys already carry 1/4-scale intrinsics and an inverse-depth sweep row.
    """
    images, cams = [], []
    for v in range(view_num):
        img = image_io.imread(os.path.join(data_root, f"{v}.jpg"))
        cam = np.load(os.path.join(data_root, f"{v}_cam.npy"))
        images.append(img)
        cams.append(cam)
    images = np.stack(images)[None].astype(np.float32)  # (1, N, H, W, 3) BGR
    cams = np.stack(cams)[None].astype(np.float32)
    gt_path = os.path.join(data_root, "0_gt.npy")
    depth_gt = np.load(gt_path) if os.path.exists(gt_path) else None
    return images, cams, depth_gt
