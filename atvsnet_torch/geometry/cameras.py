"""Camera parameter handling (MVSNet layout), as in atvsnet_tpu/geometry/cameras.py.

  cam: (..., 2, 4, 4) float32
    cam[..., 0, :, :]   4x4 extrinsic [R|t; 0 0 0 1], world -> camera
    cam[..., 1, :3, :3] 3x3 intrinsic K at the cost-volume resolution
    cam[..., 1, 3, :]   depth sweep row [depth_start, depth_interval, num_d, depth_end]
"""

from __future__ import annotations

import numpy as np
import torch


def split_cam(cam: torch.Tensor):
    """(..., 2, 4, 4) -> K (...,3,3), R (...,3,3), t (...,3,1)."""
    R = cam[..., 0, :3, :3]
    t = cam[..., 0, :3, 3:4]
    K = cam[..., 1, :3, :3]
    return K, R, t


def camera_center(cam: torch.Tensor) -> torch.Tensor:
    """World-space camera center c = -R^T t, shape (..., 3, 1)."""
    _, R, t = split_cam(cam)
    return -(R.transpose(-1, -2) @ t)


def depth_range_from_cams(cams: torch.Tensor):
    """depth_start and depth_interval of the reference (index-0) camera, two (B,) vectors
    from cams (B, N, 2, 4, 4), as reference atvsnet/example.py:66-69 slices them."""
    return cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]


def scale_camera_np(cam: np.ndarray, scale: float) -> np.ndarray:
    """Scale the intrinsics (fx, fy, cx, cy) of one (2, 4, 4) cam for a resized image
    (numpy, host side; reference atvsnet/preprocess.py:27-36)."""
    new_cam = np.copy(cam)
    new_cam[1][0][0] = cam[1][0][0] * scale
    new_cam[1][1][1] = cam[1][1][1] * scale
    new_cam[1][0][2] = cam[1][0][2] * scale
    new_cam[1][1][2] = cam[1][1][2] * scale
    return new_cam
