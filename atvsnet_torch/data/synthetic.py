"""Synthetic multi-view scenes: random images over a small camera rig.

A numpy-only copy of atvsnet_tpu/data/synthetic.py, kept here so the port never
imports the JAX package (tests/test_torch_bridge.py holds the two copies equal).
It feeds chip_smoke.py and the port's tests. Cameras use the MVSNet (2,4,4) cam
layout (extrinsic 4x4; intrinsic 3x3 + depth row [start, interval, num, end]),
with intrinsics at the 1/4 cost-volume scale.
"""

from __future__ import annotations

import os

import numpy as np

from atvsnet_torch.data import image_io


def rotation(axis, angle) -> np.ndarray:
    """Rotation matrix about `axis` by `angle` (Rodrigues via quaternion)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.cos(angle / 2.0)
    b, c, d = -axis * np.sin(angle / 2.0)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    )


def make_cam(K, R, t, depth_start=0.5, depth_interval=0.05, num_d=8) -> np.ndarray:
    """Assemble one (2,4,4) MVSNet-layout camera."""
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    cam[0, :3, :3] = R
    cam[0, :3, 3] = t
    cam[0, 3, 3] = 1.0
    cam[1, :3, :3] = K
    cam[1, 3, 0] = depth_start
    cam[1, 3, 1] = depth_interval
    cam[1, 3, 2] = num_d
    cam[1, 3, 3] = depth_start + depth_interval * num_d
    return cam


def synthetic_scene(view_num=3, H=32, W=32, D=8, seed=0):
    """Random images + a small camera rig; intrinsics at 1/4 scale (MVSNet convention).

    Returns (images (1,V,H,W,3) float32 in [0,1), cams (1,V,2,4,4) float32).
    """
    rng = np.random.RandomState(seed)
    K = np.array([[W / 4.0, 0.0, W / 8.0], [0.0, W / 4.0, H / 8.0], [0.0, 0.0, 1.0]])
    images = rng.rand(1, view_num, H, W, 3).astype(np.float32)
    cams = []
    for v in range(view_num):
        R = rotation([0.0, 1.0, 0.1], 0.04 * v)
        t = np.array([0.1 * v, 0.02 * v, 0.0])
        cams.append(make_cam(K, R, t, depth_start=0.5, depth_interval=0.05, num_d=D))
    cams = np.stack(cams)[None].astype(np.float32)
    return images, cams


def _bilinear_wrap(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample a (T, T, 3) texture at continuous (u, v) with wrap addressing."""
    T = tex.shape[0]
    u = np.mod(u, T)
    v = np.mod(v, T)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u1 = (u0 + 1) % T
    v1 = (v0 + 1) % T
    return (
        tex[v0, u0] * (1 - fv) * (1 - fu)
        + tex[v0, u1] * (1 - fv) * fu
        + tex[v1, u0] * fv * (1 - fu)
        + tex[v1, u1] * fv * fu
    )


def render_multiplane_views(
    n_images: int,
    H: int,
    W: int,
    seed: int = 0,
    num_planes: int = 4,
    depth_min: float = 1.0,
    depth_max: float = 2.0,
    tex_res: int = 96,
    spacing: float = 0.09,
    rot_step: float = 0.035,
    jitter: bool = True,
    num_spheres: int = 0,
):
    """Core renderer: n_images photo-consistent views of a random plane envelope,
    optionally with `num_spheres` textured spheres floating in front of it.

    Spheres (VERDICT r4 item 2) add exactly what the plane envelope cannot:
    CURVED surfaces (depth varies quadratically along the surface, so no single
    sweep plane fits a patch) and OCCLUSION BOUNDARIES between objects (a sphere
    edge occludes different background in different views — the geometry the
    refinement/visual-hull stages exist for, reference model.py:227-339).
    Sphere parameters are drawn AFTER all plane draws so num_spheres=0 is
    bit-identical to the pre-r5 renderer (the committed r4 checkpoints' train and
    held-out scene streams are unchanged).

    Returns a dict: images (N, H, W, 3) float32 in [0,1], K_full (3,3) full-res
    intrinsics, Rs (N,3,3), ts (N,3) extrinsics, depths (N, H, W) float32 metric
    camera-frame depth per view (for gt emission / fusion oracles).
    """
    rng = np.random.RandomState(seed)

    fx = float(W)
    K_full = np.array([[fx, 0.0, W / 2.0], [0.0, fx, H / 2.0], [0.0, 0.0, 1.0]])

    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for v in range(1, n_images):
        axis = np.array([0.0, 1.0, 0.1]) + (rng.randn(3) * 0.03 if jitter else 0.0)
        ang = rot_step * v + (rng.randn() * 0.008 if jitter else 0.0)
        Rv = rotation(axis, ang)
        tv = np.array([spacing * v, 0.22 * spacing * v, 0.0])
        if jitter:
            tv = tv + rng.randn(3) * 0.1 * spacing
        Rs.append(Rv)
        ts.append(tv)

    # world: lower envelope of random slanted planes z = z0 + a x + b y,
    # each carrying its own wrapped random texture
    mid_lo = depth_min + 0.15 * (depth_max - depth_min)
    mid_hi = depth_max - 0.15 * (depth_max - depth_min)
    z0 = rng.uniform(mid_lo, mid_hi, size=num_planes)
    ab = rng.uniform(-0.22, 0.22, size=(num_planes, 2))
    texs = rng.rand(num_planes, tex_res, tex_res, 3).astype(np.float32)
    # smooth the textures a little so bilinear resampling across views is benign
    for _ in range(2):
        texs = 0.5 * texs + 0.125 * (
            np.roll(texs, 1, 1) + np.roll(texs, -1, 1)
            + np.roll(texs, 1, 2) + np.roll(texs, -1, 2)
        )
    tex_freq = rng.uniform(28.0, 46.0, size=num_planes)

    # spheres: drawn after every plane draw (num_spheres=0 leaves the RNG stream —
    # and so every existing seed's scene — untouched). Centered in the front half
    # of the depth range on rays through the image so they are actually seen.
    if num_spheres > 0:
        span = depth_max - depth_min
        sp_rad = rng.uniform(0.08, 0.22, num_spheres) * span
        # place by the FRONT surface depth: strictly closer than the plane
        # envelope's band (z0 >= depth_min + 0.15 span) so each sphere is
        # guaranteed to occlude background in view 0 regardless of the plane draws
        sp_front = rng.uniform(0.02 * span, 0.12 * span, num_spheres) + depth_min
        sp_z = sp_front + sp_rad
        sp_xy = rng.uniform(-0.3, 0.3, size=(num_spheres, 2)) * sp_z[:, None]
        sp_ctr = np.concatenate([sp_xy, sp_z[:, None]], axis=1)      # (S, 3)
        sp_tex = rng.rand(num_spheres, tex_res, tex_res, 3).astype(np.float32)
        for _ in range(2):
            sp_tex = 0.5 * sp_tex + 0.125 * (
                np.roll(sp_tex, 1, 1) + np.roll(sp_tex, -1, 1)
                + np.roll(sp_tex, 1, 2) + np.roll(sp_tex, -1, 2)
            )
        sp_freq = rng.uniform(28.0, 46.0, num_spheres)

    def trace(Rv, tv, height, width, Kmat):
        """Intersect all pixels' rays with the plane envelope (+ spheres).

        Returns (color (h, w, 3), depth (h, w) camera-frame metric depth)."""
        Cv = -Rv.T @ tv
        xs = (np.arange(width, dtype=np.float64) + 0.5 - Kmat[0, 2]) / Kmat[0, 0]
        ys = (np.arange(height, dtype=np.float64) + 0.5 - Kmat[1, 2]) / Kmat[1, 1]
        gx, gy = np.meshgrid(xs, ys)
        dirs = np.stack([gx, gy, np.ones_like(gx)], axis=-1) @ Rv  # (h, w, 3) = R^T d
        # plane i: n_i . X = c_i with n = (-a, -b, 1), c = z0
        n = np.concatenate([-ab, np.ones((num_planes, 1))], axis=1)  # (P, 3)
        denom = dirs @ n.T                                           # (h, w, P)
        s = (z0[None, None] - (n @ Cv)[None, None]) / np.where(denom == 0, 1e-12, denom)
        s = np.where(s > 1e-6, s, np.inf)
        if num_spheres > 0:
            # ray-sphere: |Cv + s d - ctr|^2 = r^2, near root; occlusion falls out
            # of the global argmin below
            oc = Cv[None] - sp_ctr                                   # (S, 3)
            a_q = np.sum(dirs * dirs, axis=-1)[..., None]            # (h, w, 1)
            b_q = 2.0 * (dirs @ oc.T)                                # (h, w, S)
            c_q = (np.sum(oc * oc, axis=-1) - sp_rad**2)[None, None]  # (1, 1, S)
            disc = b_q * b_q - 4.0 * a_q * c_q
            sqrt_disc = np.sqrt(np.maximum(disc, 0.0))
            s_sp = (-b_q - sqrt_disc) / (2.0 * a_q)
            s_sp = np.where((disc > 0.0) & (s_sp > 1e-6), s_sp, np.inf)
            s = np.concatenate([s, s_sp], axis=-1)                   # (h, w, P+S)
        pick = np.argmin(s, axis=-1)                                 # (h, w)
        s_hit = np.take_along_axis(s, pick[..., None], axis=-1)[..., 0]
        s_hit = np.where(np.isfinite(s_hit), s_hit, depth_max)
        X = Cv[None, None] + s_hit[..., None] * dirs                 # (h, w, 3)
        depth = (X @ Rv.T + tv)[..., 2]                              # camera z
        color = np.zeros(X.shape[:2] + (3,), np.float32)
        for p in range(num_planes + num_spheres):
            m = pick == p
            if not m.any():
                continue
            if p < num_planes:
                tex, freq = texs[p], tex_freq[p]
                u = X[..., 0][m] * freq
                vv = X[..., 1][m] * freq
            else:
                # sphere texture = function of the surface point's direction from
                # the center (view-independent, so photo-consistent): azimuth /
                # polar angles scaled by the texture frequency
                sidx = p - num_planes
                tex, freq = sp_tex[sidx], sp_freq[sidx]
                rel = X[m] - sp_ctr[sidx]
                u = np.arctan2(rel[..., 1], rel[..., 0]) * freq * 0.15 * sp_rad[sidx]
                vv = np.arccos(
                    np.clip(rel[..., 2] / np.maximum(
                        np.linalg.norm(rel, axis=-1), 1e-12), -1.0, 1.0)
                ) * freq * 0.15 * sp_rad[sidx]
            color[m] = _bilinear_wrap(tex, u, vv)
        return color, depth.astype(np.float32)

    images = np.zeros((n_images, H, W, 3), np.float32)
    depths = np.zeros((n_images, H, W), np.float32)
    for v in range(n_images):
        color, depth = trace(Rs[v], ts[v], H, W, K_full)
        images[v] = np.clip(color, 0.0, 1.0)
        depths[v] = depth
    return {
        "images": images,
        "K_full": K_full,
        "Rs": np.stack(Rs),
        "ts": np.stack(ts),
        "depths": depths,
        "trace": trace,
    }


def render_multiplane_scene(
    view_num: int = 3,
    H: int = 128,
    W: int = 160,
    D: int = 32,
    seed: int = 0,
    num_planes: int = 4,
    inverse_depth: bool = True,
    depth_min: float = 1.0,
    depth_max: float = 2.0,
    tex_res: int = 96,
    noise: float = 0.0,
    num_spheres: int = 0,
):
    """PHOTOMETRICALLY CONSISTENT multi-view renders of a piecewise-planar world
    (optionally with `num_spheres` floating spheres — curved surfaces + occlusion
    boundaries; see render_multiplane_views).

    Unlike synthetic_scene (independent random images — fine for smoke tests,
    useless as supervision), every view here images the SAME textured surface
    (the lower envelope of `num_planes` random slanted planes), so a multi-view
    stereo network can actually learn depth from it: matching costs are
    informative, the gt is the true geometry, and scenes vary by seed (planes,
    textures, camera rig jitter). This closes the accuracy loop the missing
    reference checkpoint leaves open (reference atvsnet/example.py:122-124 —
    model.zip is a missing blob): train on seeds, evaluate on held-out seeds.

    Rays go through half-pixel centers, matching the warp convention the model
    uses (reference homography_warping.py:8-17).

    Returns a dict:
      images      (1, V, H, W, 3) float32 in [0, 1]
      cams        (1, V, 2, 4, 4) — intrinsics at 1/4 scale (MVSNet convention),
                  depth row = sweep params [start, interval, D, end] in
                  inverse-depth units when `inverse_depth` (reference
                  eval_pointcloud.py:153-169 convention)
      depth_gt    (1, H//4, W//4, 1) float32 — ref-view gt in SWEEP space
                  (what models/train.training_loss consumes)
      depth_gt_metric (H//4, W//4) float32 — same gt in metric depth
    """
    r = render_multiplane_views(
        n_images=view_num, H=H, W=W, seed=seed, num_planes=num_planes,
        depth_min=depth_min, depth_max=depth_max, tex_res=tex_res,
        num_spheres=num_spheres,
    )
    V = view_num
    if inverse_depth:
        start, end = 1.0 / depth_max, 1.0 / depth_min
    else:
        start, end = depth_min, depth_max
    interval = (end - start) / D

    images = r["images"]
    if noise > 0:
        rng = np.random.RandomState(seed + 7)
        images = np.clip(
            images + rng.randn(*images.shape).astype(np.float32) * noise, 0.0, 1.0
        )
    K_quarter = r["K_full"].copy()
    K_quarter[:2] /= 4.0
    cams = np.stack(
        [make_cam(K_quarter, r["Rs"][v], r["ts"][v], start, interval, D) for v in range(V)]
    )

    _, depth_q = r["trace"](r["Rs"][0], r["ts"][0], H // 4, W // 4, K_quarter)
    gt_metric = np.clip(depth_q, depth_min, depth_max)
    gt_sweep = (1.0 / gt_metric if inverse_depth else gt_metric).astype(np.float32)
    return {
        "images": images[None],
        "cams": cams[None],
        "depth_gt": gt_sweep[None, ..., None],
        "depth_gt_metric": gt_metric,
    }


def synthetic_batch(view_num=3, B=1, H=32, W=32, D=8, seed=0):
    """synthetic_scene stacked to batch B (replicated cams, perturbed images)."""
    images, cams = synthetic_scene(view_num=view_num, H=H, W=W, D=D, seed=seed)
    if B > 1:
        rng = np.random.RandomState(seed + 1)
        reps = [images] + [
            images + rng.standard_normal(images.shape).astype(images.dtype) * 0.05
            for _ in range(B - 1)
        ]
        images = np.concatenate(reps, axis=0)
        cams = np.concatenate([cams] * B, axis=0)
    return images, cams


def write_example_dir(data_root: str, scene: dict) -> None:
    """Write a render_multiplane_scene result as an example/{i} directory, the layout
    data.preprocess.load_example_dir reads: {v}.jpg (uint8), {v}_cam.npy and 0_gt.npy
    (the metric ground truth repeated 4x to the images' size). Not in the JAX package's
    copy of this module; encoding goes through data.image_io."""
    os.makedirs(data_root, exist_ok=True)
    for v, (image, cam) in enumerate(zip(scene["images"][0], scene["cams"][0])):
        image_io.imwrite(os.path.join(data_root, f"{v}.jpg"), np.uint8(np.round(image * 255.0)))
        np.save(os.path.join(data_root, f"{v}_cam.npy"), cam)
    gt = scene["depth_gt_metric"]
    np.save(os.path.join(data_root, "0_gt.npy"), gt.repeat(4, axis=0).repeat(4, axis=1))


def write_eth3d_scene(scene_dir: str, n_images: int, H: int, W: int, seed: int,
                      depth_min: float = 1.0, depth_max: float = 2.0, num_d: int = 128,
                      num_spheres: int = 0) -> None:
    """Fabricate a photo-consistent ETH3D-format scene: every image renders the same world
    (render_multiplane_views), so trained weights give depth maps that agree across
    reference views and the fusion emits a real point cloud. The port's copy of
    tools/make_planes_eth3d.make_scene, which writes the same bytes.

    Layout, as cli.eval_pointcloud reads it (reference eval_pointcloud.py:61-93):
    images/%08d.jpg (JPEG quality 98), cams/%08d_cam.txt with FULL-resolution intrinsics
    and a METRIC depth range (the eval script converts it to the inverse sweep itself),
    pair.txt with nearest-neighbor view lists, and gt_depths/%08d.pfm (metric).
    """
    from atvsnet_torch.data.cams import write_cam
    from atvsnet_torch.data.pfm import save_pfm

    r = render_multiplane_views(
        n_images, H, W, seed=seed, depth_min=depth_min, depth_max=depth_max,
        spacing=0.05, rot_step=0.02, num_spheres=num_spheres,
    )
    for sub in ("images", "cams", "gt_depths"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    interval = (depth_max - depth_min) / num_d
    entries = []
    for v in range(n_images):
        img = (r["images"][v] * 255.0).astype(np.uint8)
        image_io.imwrite(os.path.join(scene_dir, "images", f"{v:08d}.jpg"),
                         np.ascontiguousarray(img[..., ::-1]), jpeg_quality=98)  # RGB -> BGR
        cam = make_cam(r["K_full"], r["Rs"][v], r["ts"][v], depth_min, interval, num_d)
        write_cam(os.path.join(scene_dir, "cams", f"{v:08d}_cam.txt"), cam)
        save_pfm(os.path.join(scene_dir, "gt_depths", f"{v:08d}.pfm"), r["depths"][v])
        others = sorted((o for o in range(n_images) if o != v), key=lambda o: abs(o - v))
        entries.append(
            f"{v}\n{len(others)} " + " ".join(f"{o} 10.0" for o in others) + "\n"
        )
    with open(os.path.join(scene_dir, "pair.txt"), "w") as f:
        f.write(f"{n_images}\n" + "".join(entries))
