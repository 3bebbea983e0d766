"""Host-side preparation of a request, as the reference eval script does it
(daiszh/A-TVSNet atvsnet/eval_pointcloud.py:96-209 and atvsnet/preprocess.py): views
padded with the reference, adaptive down-scaling into the (max_h, max_w) bucket or, for a
smaller request, edge padding up to it, a centre crop to multiples of 32 with the
principal point shifted, the metric depth row turned into an inverse-depth sweep of
max_d planes, and the intrinsics scaled to the cost volume's resolution.

The frames stay uint8; the variance normalization runs on the device (model.center_images).
Resizing is OpenCV's bilinear resize, the codec every side of a run uses.
"""

from __future__ import annotations

import math

import numpy as np


def scale_cam(cam: np.ndarray, scale: float) -> np.ndarray:
    cam = np.copy(cam)
    for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)):
        cam[1][i][j] = cam[1][i][j] * scale
    return cam


def resize(image: np.ndarray, scale: float) -> np.ndarray:
    if scale == 1.0:
        return image
    import cv2

    return cv2.resize(image, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR)


def inverse_depth_row(cam: np.ndarray, max_d: int) -> np.ndarray:
    """[start, interval, planes, end] in depth -> max_d equal steps of inverse depth from
    1 / end to 1 / start."""
    cam = np.copy(cam)
    start, interval = cam[1][3][0], cam[1][3][1]
    if cam[1][3][2] > 0 and cam[1][3][3] > 0:
        end = cam[1][3][3]
    else:
        end = start + float(max_d - 1) * interval
    lo, hi = 1.0 / end, 1.0 / start
    cam[1][3][0], cam[1][3][1], cam[1][3][2], cam[1][3][3] = lo, (hi - lo) / max_d, max_d, hi
    return cam


def prepare(images, cams, view_num: int, max_d: int, max_h: int, max_w: int,
            sample_scale: float = 0.25, base: int = 32) -> dict:
    """[ref, views...] (H, W, 3) frames and (2, 4, 4) cams -> images (1, N, max_h, max_w,
    3) as given (uint8), cams (1, N, 2, 4, 4) float32, and the valid (un-padded) size of
    the reference at full resolution."""
    images = list(images)[:view_num]
    cams = [np.copy(c) for c in cams[:view_num]]
    while len(images) < view_num:
        images.append(images[0])
        cams.append(np.copy(cams[0]))
    for cam in cams:
        if cam[1][3][2] == 0:
            cam[1][3][2] = max_d
    h_scale = max(float(max_h) / im.shape[0] for im in images)
    w_scale = max(float(max_w) / im.shape[1] for im in images)
    padded = h_scale > 1 or w_scale > 1
    scale = 1.0 if padded else max(h_scale, w_scale)
    images = [resize(im, scale) for im in images]
    cams = [scale_cam(c, scale) for c in cams]
    valid = (min(images[0].shape[0], max_h), min(images[0].shape[1], max_w))
    if padded:
        images = [np.pad(im, ((0, max(0, max_h - im.shape[0])), (0, max(0, max_w - im.shape[1])),
                              (0, 0)), mode="edge")
                  if im.shape[0] < max_h or im.shape[1] < max_w else im for im in images]
    out_images, out_cams = [], []
    for im, cam in zip(images, cams):
        h, w = im.shape[:2]
        new_h = max_h if h > max_h else int(math.ceil(h / base) * base)
        new_w = max_w if w > max_w else int(math.ceil(w / base) * base)
        if new_h > h:
            new_h = (h // base) * base
        if new_w > w:
            new_w = (w // base) * base
        top, left = int(math.ceil((h - new_h) / 2)), int(math.ceil((w - new_w) / 2))
        out_images.append(im[top:top + new_h, left:left + new_w])
        cam = np.copy(cam)
        cam[1][0][2] -= left
        cam[1][1][2] -= top
        out_cams.append(cam)
    out_cams = [scale_cam(inverse_depth_row(c, max_d), sample_scale) for c in out_cams]
    return {"images": np.stack(out_images)[None],
            "cams": np.stack(out_cams)[None].astype(np.float32),
            "valid_hw": valid}
