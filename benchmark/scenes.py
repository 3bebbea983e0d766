"""Seeded multi-view scenes: the benchmark's generator of frames, cameras and ETH3D-format
scene folders.

A rig of cameras looks at the lower envelope of random slanted textured planes with
textured spheres in front of it (curved surfaces and occlusion boundaries); every frame
renders the same world, so a trained network gives depth maps that agree across views and
the fusion emits a real cloud. Rays go through half-pixel centres. A copy of the port's
renderer (atvsnet_torch/data/synthetic.py: render_multiplane_views, write_eth3d_scene), so
that the traffic cannot change when the program does. Cameras use the MVSNet (2, 4, 4)
layout: extrinsic [R | t], full-resolution intrinsics, and the metric depth row
[start, interval, planes, end].
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.reference.io import write_cam, write_pfm


def rotation(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.cos(angle / 2.0)
    b, c, d = -axis * np.sin(angle / 2.0)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
    ])


def make_cam(K, R, t, depth_start, depth_interval, num_d) -> np.ndarray:
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    cam[0, :3, :3], cam[0, :3, 3], cam[0, 3, 3] = R, t, 1.0
    cam[1, :3, :3] = K
    cam[1, 3] = (depth_start, depth_interval, num_d, depth_start + depth_interval * num_d)
    return cam


def _bilinear_wrap(tex, u, v):
    T = tex.shape[0]
    u, v = np.mod(u, T), np.mod(v, T)
    u0, v0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u1, v1 = (u0 + 1) % T, (v0 + 1) % T
    return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u1] * (1 - fv) * fu
            + tex[v1, u0] * fv * (1 - fu) + tex[v1, u1] * fv * fu)


def _smooth(t):
    for _ in range(2):
        t = 0.5 * t + 0.125 * (np.roll(t, 1, 1) + np.roll(t, -1, 1)
                               + np.roll(t, 1, 2) + np.roll(t, -1, 2))
    return t


def render_rig(n_images: int, H: int, W: int, seed: int, num_spheres: int = 3,
               num_planes: int = 4, depth_min: float = 1.0, depth_max: float = 2.0,
               spacing: float = 0.05, rot_step: float = 0.02, tex_res: int = 96,
               threads: int = 1) -> dict:
    """n_images views of one random world: images (N, H, W, 3) float32 in [0, 1], K_full,
    Rs (N, 3, 3), ts (N, 3), depths (N, H, W) metric camera-frame depth. `threads` views
    render at once (numpy releases the GIL in its array loops); the pixels do not depend
    on it."""
    rng = np.random.RandomState(seed % (2 ** 32))
    K = np.array([[float(W), 0.0, W / 2.0], [0.0, float(W), H / 2.0], [0.0, 0.0, 1.0]])
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for v in range(1, n_images):
        axis = np.array([0.0, 1.0, 0.1]) + rng.randn(3) * 0.03
        Rs.append(rotation(axis, rot_step * v + rng.randn() * 0.008))
        ts.append(np.array([spacing * v, 0.22 * spacing * v, 0.0]) + rng.randn(3) * 0.1 * spacing)
    span = depth_max - depth_min
    z0 = rng.uniform(depth_min + 0.15 * span, depth_max - 0.15 * span, size=num_planes)
    ab = rng.uniform(-0.22, 0.22, size=(num_planes, 2))
    texs = _smooth(rng.rand(num_planes, tex_res, tex_res, 3).astype(np.float32))
    tex_freq = rng.uniform(28.0, 46.0, size=num_planes)
    sp_rad = rng.uniform(0.08, 0.22, num_spheres) * span
    sp_z = rng.uniform(0.02 * span, 0.12 * span, num_spheres) + depth_min + sp_rad
    sp_xy = rng.uniform(-0.3, 0.3, size=(num_spheres, 2)) * sp_z[:, None]
    sp_ctr = np.concatenate([sp_xy, sp_z[:, None]], axis=1)
    sp_tex = _smooth(rng.rand(num_spheres, tex_res, tex_res, 3).astype(np.float32))
    sp_freq = rng.uniform(28.0, 46.0, num_spheres)
    n = np.concatenate([-ab, np.ones((num_planes, 1))], axis=1)

    def trace(R, t):
        Cv = -R.T @ t
        xs = (np.arange(W, dtype=np.float64) + 0.5 - K[0, 2]) / K[0, 0]
        ys = (np.arange(H, dtype=np.float64) + 0.5 - K[1, 2]) / K[1, 1]
        gx, gy = np.meshgrid(xs, ys)
        dirs = np.stack([gx, gy, np.ones_like(gx)], axis=-1) @ R
        denom = dirs @ n.T
        s = (z0[None, None] - (n @ Cv)[None, None]) / np.where(denom == 0, 1e-12, denom)
        s = np.where(s > 1e-6, s, np.inf)
        if num_spheres:
            oc = Cv[None] - sp_ctr
            a_q = np.sum(dirs * dirs, axis=-1)[..., None]
            b_q = 2.0 * (dirs @ oc.T)
            disc = b_q * b_q - 4.0 * a_q * (np.sum(oc * oc, axis=-1) - sp_rad ** 2)[None, None]
            s_sp = (-b_q - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a_q)
            s = np.concatenate([s, np.where((disc > 0.0) & (s_sp > 1e-6), s_sp, np.inf)], -1)
        pick = np.argmin(s, axis=-1)
        s_hit = np.take_along_axis(s, pick[..., None], axis=-1)[..., 0]
        s_hit = np.where(np.isfinite(s_hit), s_hit, depth_max)
        X = Cv[None, None] + s_hit[..., None] * dirs
        color = np.zeros(X.shape[:2] + (3,), np.float32)
        for p in range(num_planes + num_spheres):
            m = pick == p
            if not m.any():
                continue
            if p < num_planes:
                tex, u, vv = texs[p], X[..., 0][m] * tex_freq[p], X[..., 1][m] * tex_freq[p]
            else:
                i = p - num_planes
                rel = X[m] - sp_ctr[i]
                k = sp_freq[i] * 0.15 * sp_rad[i]
                tex = sp_tex[i]
                u = np.arctan2(rel[..., 1], rel[..., 0]) * k
                vv = np.arccos(np.clip(rel[..., 2] / np.maximum(
                    np.linalg.norm(rel, axis=-1), 1e-12), -1.0, 1.0)) * k
            color[m] = _bilinear_wrap(tex, u, vv)
        return np.clip(color, 0.0, 1.0), (X @ R.T + t)[..., 2].astype(np.float32)

    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(threads) as pool:
            rendered = list(pool.map(trace, Rs, ts))
    else:
        rendered = [trace(R, t) for R, t in zip(Rs, ts)]
    return {"images": np.stack([c for c, _ in rendered]), "K_full": K, "Rs": np.stack(Rs),
            "ts": np.stack(ts), "depths": np.stack([d for _, d in rendered]),
            "depth_min": depth_min, "depth_max": depth_max}


def rig_cams(rig: dict, num_d: int) -> np.ndarray:
    """(N, 2, 4, 4) cams with full-resolution intrinsics and the metric depth row."""
    interval = (rig["depth_max"] - rig["depth_min"]) / num_d
    return np.stack([make_cam(rig["K_full"], R, t, rig["depth_min"], interval, num_d)
                     for R, t in zip(rig["Rs"], rig["ts"])])


def frames_uint8(rig: dict) -> np.ndarray:
    """The frames as OpenCV holds them: (N, H, W, 3) uint8 BGR."""
    return np.ascontiguousarray((rig["images"] * 255.0).astype(np.uint8)[..., ::-1])


def write_eth3d_scene(scene_dir: str, rig: dict, num_d: int) -> None:
    """The ETH3D layout that the eval driver reads: images/%08d.jpg (JPEG quality 98),
    cams/%08d_cam.txt (full-resolution intrinsics, metric depth row), pair.txt with every
    other view as a neighbour, nearest first, and gt_depths/%08d.pfm."""
    import cv2

    n = rig["images"].shape[0]
    for sub in ("images", "cams", "gt_depths"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    frames, cams = frames_uint8(rig), rig_cams(rig, num_d)
    entries = []
    for v in range(n):
        if not cv2.imwrite(os.path.join(scene_dir, "images", f"{v:08d}.jpg"), frames[v],
                           [int(cv2.IMWRITE_JPEG_QUALITY), 98]):
            raise OSError(f"could not write {scene_dir}/images/{v:08d}.jpg")
        write_cam(os.path.join(scene_dir, "cams", f"{v:08d}_cam.txt"), cams[v])
        write_pfm(os.path.join(scene_dir, "gt_depths", f"{v:08d}.pfm"), rig["depths"][v])
        others = sorted((o for o in range(n) if o != v), key=lambda o: abs(o - v))
        entries.append(f"{v}\n{len(others)} " + " ".join(f"{o} 10.0" for o in others) + "\n")
    write_pairs(scene_dir, entries)


def write_pairs(scene_dir: str, entries: list) -> None:
    with open(os.path.join(scene_dir, "pair.txt"), "w") as f:
        f.write(f"{len(entries)}\n" + "".join(entries))
