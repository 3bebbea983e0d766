"""Free-space visual hull over initial depth maps (atvsnet_tpu/geometry/visual_hull.py).

For every sweep plane d and pixel p, counts how many views' depth estimates claim the
space at (p, d) is in front of the observed surface, normalized by view count.
Reference: atvsnet/homography_warping.py:329-387 — there a D x (N-1) python loop of
single-plane nearest warps; here one plane-sweep warp per view (all D at once).

The refinement (models/tvsnet.refinement) computes the same hull inline, from the nearest
warp it shares with its other sweeps; this is the standalone function.
"""

from __future__ import annotations

import torch

from atvsnet_torch.geometry.homography import get_homographies, sweep_depths
from atvsnet_torch.geometry.warp import plane_sweep_warp, transform_depth


def get_visual_hull(
    depth_images: torch.Tensor,
    cams: torch.Tensor,
    depth_num: int,
    depth_start: torch.Tensor,
    depth_interval: torch.Tensor,
    ref_id: int = 0,
    view_num: int | None = None,
    inverse_depth: bool = True,
) -> torch.Tensor:
    """depth_images (B, N, H, W), cams (B, N, 2, 4, 4) -> hull (B, D, H, W, 1).

    Note: the reference passes the FULL cams stack with 2-entry depth stacks during
    per-pair refinement and indexes cameras by reordered position, which reads camera 1
    regardless of the actual pair view when view_i > 1 (homography_warping.py:344-358
    with model.py:323). Here callers pass per-pair stacks [ref, view] so the camera
    always matches the depth map it came from.
    """
    B, N, H, W = depth_images.shape
    if view_num is None:
        view_num = N

    id_reorder = list(range(view_num))
    id_reorder[0] = ref_id
    id_reorder[ref_id] = 0

    f32 = torch.float32
    ref_cam = cams[:, ref_id]
    ref_depth = depth_images[:, ref_id].to(f32)            # (B, H, W)

    sweep = sweep_depths(depth_start.to(f32), depth_interval.to(f32), depth_num)
    sweep = sweep[:, :, None, None]                        # (B, D, 1, 1)

    def free_space(depth_bdhw):
        cmp = depth_bdhw > sweep if inverse_depth else sweep > depth_bdhw
        return ((depth_bdhw > 0) & cmp).to(f32)

    hull = free_space(ref_depth[:, None].expand(B, depth_num, H, W))

    for view_i in id_reorder[1:]:
        view_cam = cams[:, view_i]
        homographies = get_homographies(
            ref_cam, view_cam, depth_num, depth_start, depth_interval, inverse_depth
        )
        view_depth = depth_images[:, view_i].to(f32)
        trans = transform_depth(view_depth[..., None], view_cam, ref_cam, inverse_depth)
        warped = plane_sweep_warp(trans, homographies, method="nearest")
        hull = hull + free_space(warped[..., 0])           # (B, D, H, W)

    hull = hull / float(view_num)
    return hull[..., None]
