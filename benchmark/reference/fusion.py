"""The point cloud of a scene's depth maps, as fusibile computes it with the settings of
the reference's depth_fusion.py (confidence filter at 0.8, relative disparity threshold
0.01, at least 2 consistent views, depths in [0.01, 1e5], every view a reference in turn,
fake unit normals so the normal test always passes).

For a reference camera r and its pixel p (integer coordinates) of depth d > 0:
X = M_r^-1 (d p - p4_r). In every other view i, X projects to (x, y) at depth z; inside
the image, the view's depth z_i is read bilinearly (texture clamp at the border), and the
view agrees when |f_r b_ri / z - f_r b_ri / z_i| / (f_r b_ri / z) < 0.01, with b_ri the
baseline. A pixel with 2 or more agreeing views becomes the point X. The check is float32
with the products written out, the emitted coordinates float64 from the float32 depth and
rounded to float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _rows(M, v0, v1, v2):
    return [M[..., i, 0] * v0 + M[..., i, 1] * v1 + M[..., i, 2] * v2 for i in range(3)]


def _bilinear(maps, x, y):
    """maps (V, H, W); x, y (R, V, N) -> (R, V, N), view v's map at view v's coords."""
    V, H, W = maps.shape
    x = torch.nan_to_num(x, nan=0.0, posinf=W - 1.0, neginf=0.0).clamp(0.0, W - 1.0)
    y = torch.nan_to_num(y, nan=0.0, posinf=H - 1.0, neginf=0.0).clamp(0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = maps.reshape(-1)
    off = (torch.arange(V) * (H * W)).view(1, V, 1)

    def at(iy, ix):
        return flat[off + iy * W + ix]

    return ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x1)
            + wy * (1 - wx) * at(y1, x0) + wy * wx * at(y1, x1))


@torch.no_grad()
def fuse(depths: np.ndarray, cams: np.ndarray, disp_thresh: float = 0.01,
         num_consistent: int = 2, depth_min: float = 0.01,
         depth_max: float = 1e5) -> np.ndarray:
    """depths (V, H, W) metric, 0 where filtered; cams (V, 2, 4, 4) at the maps'
    resolution -> the (M, 3) float32 points, reference camera by camera, pixels in
    row-major order."""
    depths = np.asarray(depths, np.float32)
    depths = np.where((depths >= depth_min) & (depths <= depth_max), depths, 0.0).astype(np.float32)
    cams64 = np.asarray(cams, np.float64)
    K, E = cams64[:, 1, :3, :3], cams64[:, 0, :3, :4]
    P64 = K @ E
    Minv64 = np.linalg.inv(P64[:, :, :3])
    centers = -(Minv64 @ P64[:, :, 3:4])[..., 0]
    P = torch.from_numpy(P64.astype(np.float32))
    Minv = torch.from_numpy(Minv64.astype(np.float32))
    C = torch.from_numpy(centers.astype(np.float32))
    f = torch.from_numpy(K[:, 0, 0].astype(np.float32))
    d = torch.from_numpy(depths)
    V, H, W = depths.shape
    xs = torch.arange(W, dtype=torch.float32).repeat(H)[None]
    ys = torch.arange(H, dtype=torch.float32).repeat_interleave(W)[None]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    points = []
    for r in range(V):
        depth_r = d[r].reshape(1, -1)
        X = _rows(Minv[r][None, None], depth_r * xs - P[r, 0, 3], depth_r * ys - P[r, 1, 3],
                  depth_r - P[r, 2, 3])
        Pv = P[None, :, None]
        proj = _rows(Pv, X[0][:, None], X[1][:, None], X[2][:, None])
        proj = [proj[i] + Pv[..., i, 3] for i in range(3)]
        z = proj[2]
        px, py = proj[0] / z, proj[1] / z
        others = (torch.arange(V) != r)[None, :, None]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H) & others
        z_i = _bilinear(d, px, py)
        diff = C[r][None, None] - C[None]
        fb = (f[r] * torch.sqrt((diff * diff).sum(-1)))[..., None]
        disp = fb / z
        ok = inside & (((disp - fb / z_i).abs() / disp) < disp_thresh)
        emit = ((ok.sum(dim=1) >= num_consistent) & (depth_r > 0))[0].numpy().reshape(H, W)
        dr = depths[r].astype(np.float64)[emit]
        q = np.stack([dr * gx[emit] - P64[r, 0, 3], dr * gy[emit] - P64[r, 1, 3],
                      dr - P64[r, 2, 3]])
        points.append((Minv64[r] @ q).T.astype(np.float32))
    return np.concatenate(points) if points else np.zeros((0, 3), np.float32)


def confidence_filter(depth: np.ndarray, prob: np.ndarray, threshold: float = 0.8):
    out = np.array(depth, np.float32)
    out[prob < threshold] = 0.0
    return out
