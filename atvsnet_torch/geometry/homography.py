"""Plane-sweep homographies for all depth hypotheses at once (atvsnet_tpu/geometry/homography.py).

    H_d = K_r R_r (I - c_rel n_f^T * s(d)) R_l^T K_l^{-1}

with s(d) = d for inverse-depth sweeps and 1/d otherwise, c_rel = c_r - c_l and n_f the
fronto-parallel plane normal (third row of R_l). All camera math is float32, TF32 off
whatever the process's flags say (PipelineConfig.fp32_precision does not reach geometry).
"""

from __future__ import annotations

import torch

from atvsnet_torch.geometry.cameras import split_cam
from atvsnet_torch.ops.fp32_passes import tf32


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel grid at half-pixel centers, shape (3, H*W), rows [x; y; 1]."""
    x = torch.arange(width, device=device, dtype=dtype) + 0.5
    y = torch.arange(height, device=device, dtype=dtype) + 0.5
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xg.reshape(-1), yg.reshape(-1), torch.ones_like(xg).reshape(-1)])


def sweep_depths(depth_start: torch.Tensor, depth_interval: torch.Tensor, depth_num: int) -> torch.Tensor:
    """Per-sample sweep values, shape (B, D): start + i * interval."""
    steps = torch.arange(depth_num, device=depth_start.device, dtype=depth_start.dtype)
    return depth_start[:, None] + steps[None, :] * depth_interval[:, None]


@tf32(False)
def get_homographies(
    left_cam: torch.Tensor,
    right_cam: torch.Tensor,
    depth_num: int,
    depth_start: torch.Tensor,
    depth_interval: torch.Tensor,
    inverse_depth: bool = True,
) -> torch.Tensor:
    """All D homographies mapping left (reference) pixels to right (view) pixels.

    left_cam, right_cam: (B, 2, 4, 4); depth_start, depth_interval: (B,).
    Returns (B, D, 3, 3) float32.
    """
    f32 = torch.float32
    K_l, R_l, t_l = split_cam(left_cam.to(f32))
    K_r, R_r, t_r = split_cam(right_cam.to(f32))
    depths = sweep_depths(depth_start.to(f32), depth_interval.to(f32), depth_num)  # (B, D)

    K_l_inv = torch.linalg.inv(K_l)
    R_l_T = R_l.transpose(-1, -2)
    R_r_T = R_r.transpose(-1, -2)

    fronto = R_l[:, 2:3, :]                      # (B, 1, 3) plane normal in world frame
    c_l = -(R_l_T @ t_l)                         # (B, 3, 1)
    c_r = -(R_r_T @ t_r)
    c_rel = c_r - c_l
    temp = c_rel @ fronto                        # (B, 3, 3) rank-1 c_rel n_f^T
    scale = depths if inverse_depth else 1.0 / depths
    eye = torch.eye(3, device=left_cam.device, dtype=f32)
    middle = eye[None, None] - temp[:, None] * scale[:, :, None, None]  # (B, D, 3, 3)

    back = (R_l_T @ K_l_inv)[:, None]            # (B, 1, 3, 3)
    front = (K_r @ R_r)[:, None]
    return front @ (middle @ back)
