"""Multi-view depth consistency fusion (the port of atvsnet_tpu/fusion/consistency.py,
which replaces the reference's fusibile CUDA kernel).

Semantics of reference fusibile/fusibile.cu:138-277 with the pipeline's settings
(depth_fusion.py:205-226: depth_min=0.01, depth_max=1e5, normal_thresh=360deg,
disp_thresh=0.01, num_consistent=2):

For every reference camera r and pixel p with depth d = D_r[p] (0 = filtered out):
  X = M_r^{-1} (d*u - p4_r)                      back-projection, fusibile.cu:56-65
  for every other camera i:
    (pt, z) = project(X, P_i)                    fusibile.cu:127-133
    if pt in bounds:                             fusibile.cu:195-198
      z_i = bilinear(D_i, pt + 0.5)              tex2D linear fetch, fusibile.cu:203
      disp(x) = f_r * |C_r - C_i| / x            fusibile.cu:51-54
      consistent if |disp(z) - disp(z_i)| / disp(z) < disp_thresh   fusibile.cu:211
      (normal-angle test always passes at 360 deg; pipeline uses fake unit normals,
       depth_fusion.py:92-111)
  average texture over {r} + consistent views; emit a point iff
  #consistent >= num_consistent.                 fusibile.cu:244-263

The check is plain PyTorch on `device`: a chunk of reference cameras against all V views
at once, tensors of shape (R, V, N) over N pixels. N is the dense H*W grid, or (the sparse
path) the padded list of a reference's valid pixels. One function serves both, so the two
paths do the same fp32 operations on the same values and emit the same points in the same
order. The variable-length point list is a mask compacted on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from atvsnet_torch import resolve_device
from atvsnet_torch.utils.transfer import finish_download, start_download


def select_views(
    cams: np.ndarray,
    ref_idx: int,
    width: int,
    height: int,
    min_angle_deg: float = 10.0,
    max_angle_deg: float = 30.0,
) -> np.ndarray:
    """Central-ray-angle view selection (reference fusibile/main.cpp:363-401).

    NOTE: the reference pipeline DISABLES this (viewSel=false at main.cpp:721 keeps
    all views); provided for gipuma-compatible workflows. Returns selected indices.
    """
    _, M_inv, _, _ = camera_geometry(cams)
    center_px = np.array([width / 2.0, height / 2.0, 1.0])

    def view_vector(i):
        # direction of the ray through the principal pixel: M_inv @ p (not translated)
        v = M_inv[i] @ center_px
        return v / (np.linalg.norm(v) + 1e-12)

    v_ref = view_vector(ref_idx)
    selected = []
    lo, hi = np.deg2rad(min_angle_deg), np.deg2rad(max_angle_deg)
    for i in range(cams.shape[0]):
        if i == ref_idx:
            continue
        ang = np.arccos(np.clip(v_ref @ view_vector(i), -1.0, 1.0))
        if lo < ang < hi:
            selected.append(i)
    return np.asarray(selected, dtype=np.int32)


def _geometry_from_P64(P64: np.ndarray):
    """(V, 3, 4) float64 P stack -> (P f32, M_inv f32, centers f32, f f32,
    M_inv float64 — reused by the host back-projection so the inverse is
    computed once)."""
    from atvsnet_torch.data.gipuma_io import decompose_projection

    M_inv64 = np.linalg.inv(P64[:, :, :3])
    centers = -(M_inv64 @ P64[:, :, 3:4])[..., 0]
    f = np.array([decompose_projection(p)[0][0, 0] for p in P64])
    return (
        P64.astype(np.float32),
        M_inv64.astype(np.float32),
        centers.astype(np.float32),
        f.astype(np.float32),
        M_inv64,
    )


def camera_geometry_from_P(P: np.ndarray):
    """Raw projection matrices P (V, 3, 4) -> (P f32, M_inv, centers, f).

    The generic-gipuma entry: KITTI/Strecha/Middlebury readers
    (data/gipuma_io.py, cf. fusibile/fileIoUtils.h:44-153) produce bare P
    stacks; focal length comes from the RQ decomposition exactly like the
    reference's per-camera decomposeProjectionMatrix pass
    (cameraGeometryUtils.h:318-331)."""
    return _geometry_from_P64(np.asarray(P, np.float64))[:4]


def camera_geometry(cams: np.ndarray):
    """cams (V, 2, 4, 4) -> P (V,3,4), M_inv (V,3,3), centers (V,3), f (V,)."""
    cams = np.asarray(cams, np.float64)
    K = cams[:, 1, :3, :3]
    E = cams[:, 0, :3, :4]
    P = K @ E
    M = P[:, :, :3]
    M_inv = np.linalg.inv(M)
    centers = -(M_inv @ P[:, :, 3:4])[..., 0]
    f = K[:, 0, 0]
    return (
        P.astype(np.float32),
        M_inv.astype(np.float32),
        centers.astype(np.float32),
        f.astype(np.float32),
    )


def _bilinear_sample_all_views(planes: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                               H: int, W: int) -> torch.Tensor:
    """Sample planes (C, V*H*W), the (V, H, W) maps of C channels flattened, at float pixel
    coords x, y (R, V, N): view v's coordinates sample view v's map. Returns (C, R, V, N).

    CUDA tex2D border behaviour: coordinates are clamped to [0, W-1] x [0, H-1]; of the
    four corners the far ones are clamped at the edge, where their weight is exactly 0.
    NaN and +-inf coordinates (a filtered reference pixel projects to 0/0) are made finite
    BEFORE the integer cast: an index made from them would be garbage, and an indexing
    kernel on CUDA answers an index out of range with a device-side assert. What such a
    sample reads is thrown away by the caller's bounds mask, which is computed from the
    coordinates as they were.

    The channels are planes, each corner one index_select along a plane's pixels: on an H100
    that read is some 20 times faster than picking 16-byte rows out of a (V*H*W, C) table.
    """
    V = planes.shape[1] // (H * W)
    x = torch.nan_to_num(x, nan=0.0, posinf=W - 1.0, neginf=0.0).clamp(0.0, W - 1.0)
    y = torch.nan_to_num(y, nan=0.0, posinf=H - 1.0, neginf=0.0).clamp(0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    view_off = (torch.arange(V, device=planes.device) * (H * W)).view(1, V, 1)

    def corner(iy, ix):
        rows = (view_off + iy * W + ix).reshape(-1)
        return planes.index_select(1, rows).view((planes.shape[0],) + x.shape)

    wa = (1 - wy) * (1 - wx)
    wb = (1 - wy) * wx
    wc = wy * (1 - wx)
    wd = wy * wx
    return (wa * corner(y0, x0) + wb * corner(y0, x1)
            + wc * corner(y1, x0) + wd * corner(y1, x1))


def _mat3(M: torch.Tensor, v0, v1, v2):
    """Rows of M (..., 3, >=3) times the vector (v0, v1, v2), written out as fp32
    multiply-adds: a matmul on the card may run in TF32, which moves the relative
    disparity by a tenth of disp_thresh, and K = 3 makes a poor GEMM anyway."""
    return [M[..., i, 0] * v0 + M[..., i, 1] * v1 + M[..., i, 2] * v2 for i in range(3)]


def _planes(maps: torch.Tensor) -> torch.Tensor:
    """(V, H, W, C) -> (C, V*H*W): one contiguous plane per channel."""
    return maps.reshape(-1, maps.shape[-1]).t().contiguous()


@torch.no_grad()
def fuse_ref_chunk(
    ref_idxs: torch.Tensor,        # (R,) int64 reference cameras of this chunk
    pix: torch.Tensor | None,      # (R, N) int64 flat pixel indices, or None = the dense grid
    n_valid: torch.Tensor | None,  # (R,) rows >= n_valid of pix are padding
    depths: torch.Tensor,          # (V, H, W) fp32 metric depth, 0 = invalid
    images: torch.Tensor,          # (V, H, W, 3) uint8 or float
    P: torch.Tensor,               # (V, 3, 4)
    M_inv: torch.Tensor,           # (V, 3, 3)
    centers: torch.Tensor,         # (V, 3)
    f: torch.Tensor,               # (V,)
    disp_thresh: float,
    num_consistent: int,
    normals: torch.Tensor | None = None,   # (V, H, W, 3)
    normal_thresh_rad: float = float(np.pi * 2),
):
    """The consistency check of a chunk of R reference cameras against all V views.

    With pix=None the pixel axis is the dense H*W grid; else it is each reference's padded
    list of valid (depth > 0) pixels. The sampled maps stay dense either way (other
    references still read every pixel of a view), so filtered pixels never change anyone's
    check and both forms emit the same points.

    The pipeline path (no normals) returns ONE packed (R, N, 4) uint8 tensor
    [emit, r, g, b]; world coordinates are not returned, the host recomputes them in
    float64 from its own depth maps. With normals: (emit (R, N) bool, X (R, N, 3) fp32,
    rgb (R, N, 3) uint8, normals (R, N, 3) fp32).
    """
    V, H, W = depths.shape
    hw = H * W
    dev = depths.device
    # images arrive in their storage dtype (uint8 from the decoded jpgs, a quarter of the
    # bytes to upload) and are cast here. Channels are planes from here on: (C, ...)
    planes = [depths.reshape(1, V * hw), _planes(images.to(torch.float32))]
    if normals is not None:
        planes.append(_planes(normals))
    planes = torch.cat(planes)                                         # (C, V*hw)
    if pix is None:
        N = hw
        own = planes.view(-1, V, hw)[:, ref_idxs]                      # (C, R, N)
        # back-project at INTEGER pixel coords (fusibile.cu:56-65 uses p directly)
        xs = torch.arange(W, device=dev, dtype=torch.float32).repeat(H)[None]
        ys = torch.arange(H, device=dev, dtype=torch.float32).repeat_interleave(W)[None]
    else:
        N = pix.shape[1]
        own = planes[:, ref_idxs[:, None] * hw + pix]                  # (C, R, N)
        xs = (pix % W).to(torch.float32)
        ys = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    depth_r, ref_rgb = own[0], own[1:4]                                # (R, N), (3, R, N)

    Minv_r = M_inv[ref_idxs][:, None]                                  # (R, 1, 3, 3)
    P4_r = P[ref_idxs][:, :, 3]                                        # (R, 3)
    X = _mat3(Minv_r, depth_r * xs - P4_r[:, 0:1], depth_r * ys - P4_r[:, 1:2],
              depth_r - P4_r[:, 2:3])                                  # 3 x (R, N)

    # ---- all V views checked at once: (R, V, N) ----
    Pv = P[None, :, None]                                              # (1, V, 1, 3, 4)
    proj = _mat3(Pv, X[0][:, None], X[1][:, None], X[2][:, None])
    proj = [proj[i] + Pv[..., i, 3] for i in range(3)]
    z = proj[2]
    px = proj[0] / z
    py = proj[1] / z
    not_ref = torch.arange(V, device=dev)[None, :, None] != ref_idxs[:, None, None]
    in_bounds = (px >= 0) & (px < W) & (py >= 0) & (py < H) & not_ref

    sampled = _bilinear_sample_all_views(planes, px, py, H, W)         # (C, R, V, N)
    z_i = sampled[0]
    rgb_i = sampled[1:4]

    diff = centers[ref_idxs][:, None] - centers[None]                  # (R, V, 3)
    baseline = torch.sqrt((diff * diff).sum(-1))                       # (R, V)
    fb = (f[ref_idxs][:, None] * baseline)[..., None]                  # (R, V, 1)
    disp = fb / z
    disp_i = fb / z_i
    # relative disparity check — SIGNED division exactly like fusibile.cu:211:
    # a point projecting BEHIND view i (z < 0) gives disp < 0, so rel <= 0 <
    # thresh and the view auto-passes; that reference quirk is reproduced. The
    # zero-depth reference-pixel case is closed by the emit gate below instead
    # (in the reference disp_r = inf makes every view's check nan -> False).
    rel = (disp - disp_i).abs() / disp
    ok_all = in_bounds & (rel < disp_thresh)

    if normals is not None:
        # normal-angle consistency (fusibile.cu:213-214 via getAngle_cu:118-126):
        # acos of the RAW dot product (no normalization, like the CUDA code); NaN
        # (dot product drifted past 1 on identical vectors) counts as angle 0.
        n_ref, n_i = own[4:7], sampled[4:7]                            # (3, R, N), (3, R, V, N)
        ang = torch.arccos((n_i * n_ref[:, :, None]).sum(0))
        ang = torch.where(torch.isnan(ang), 0.0, ang)
        ok_all = ok_all & (ang < normal_thresh_rad)
    # pipeline path: fake unit normals + a 360 deg threshold always pass
    # (depth_fusion.py:92-111, fusibile.cu:213-214 trivially true)
    count = ok_all.sum(dim=1)                                          # (R, N)
    denom = count + 1.0
    avg_rgb = (ref_rgb + torch.where(ok_all, rgb_i, 0.0).sum(dim=2)) / denom

    # zero-depth (prob-filtered) reference pixels back-project to the camera
    # center; without this gate a view the center projects into with NEGATIVE z
    # would auto-pass the signed disparity check above and mass-emit junk points
    # at C_r. The reference never emits them (disp_r = inf -> nan checks).
    emit = (count >= num_consistent) & (depth_r > 0)                   # (R, N)
    if n_valid is not None:
        # padding rows of the pixel lists never emit
        emit = emit & (torch.arange(N, device=dev)[None] < n_valid[:, None])
    # truncating cast, as the host compaction's; clamped first, since the cast of a float
    # out of 0..255 is not defined
    rgb8 = avg_rgb.clamp(0.0, 255.0).to(torch.uint8)                   # (3, R, N)
    if normals is None:
        return torch.cat([emit[None].to(torch.uint8), rgb8]).permute(1, 2, 0).contiguous()
    # consistent_normal accumulation (fusibile.cu:228,243): ref normal + passing
    # view normals, averaged over count+1 (points themselves are NOT averaged —
    # the reference's consistent_X accumulation is commented out, fusibile.cu:226)
    avg_nrm = (n_ref + torch.where(ok_all, n_i, 0.0).sum(dim=2)) / denom
    return emit, torch.stack(X, dim=-1), rgb8.permute(1, 2, 0), avg_nrm.permute(1, 2, 0)


def valid_pixel_lists(depths: torch.Tensor, ref_idxs: torch.Tensor, length: int) -> torch.Tensor:
    """(R, length) int64 flat indices of the valid (depth > 0) pixels of each reference's
    map, in row-major order, made on the device: a stable sort that puts the valid pixels
    first. A list shorter than `length` goes on with filtered pixels, which never emit."""
    filtered = (depths[ref_idxs].flatten(1) <= 0).to(torch.uint8)
    return torch.sort(filtered, dim=1, stable=True).indices[:, :length]


def scatter_to_grid(packed: torch.Tensor, pix: torch.Tensor, hw: int) -> torch.Tensor:
    """The sparse check's packed (R, N, 4) uint8 rows put back at their pixels of the dense
    (R, hw, 4) grid (zero elsewhere), one 4-byte word per pixel: what the dense check
    returns, so that the host treats both alike."""
    grid = torch.zeros((packed.shape[0], hw), dtype=torch.int32, device=packed.device)
    grid.scatter_(1, pix, packed.reshape(packed.shape[0], -1).view(torch.int32))
    return grid.view(torch.uint8).view(packed.shape[0], hw, 4)


def fuse_depth_maps(
    depths: np.ndarray,
    images: np.ndarray,
    cams: np.ndarray | None = None,
    disp_thresh: float = 0.01,
    num_consistent: int = 2,
    normals: np.ndarray | None = None,
    normal_thresh_deg: float = 360.0,
    depth_min: float | None = None,
    depth_max: float | None = None,
    ref_chunk: int = 4,
    P_matrices: np.ndarray | None = None,
    compact: str = "auto",
    device=None,
    timings: dict | None = None,
):
    """Fuse all views' depth maps into one point set.

    depths (V, H, W) metric depth (0 = filtered), images (V, H, W, 3) uint8/float,
    cams (V, 2, 4, 4). Returns (points (M, 3) float32, colors (M, 3) uint8) — every
    camera acts as reference in turn, like the host loop at fusibile.cu:425-430,
    `ref_chunk` references per pass of the check on `device` (CUDA when None).

    Order of work: chunk k+1 is queued on the device before the host waits for chunk k's
    download (a non-blocking copy into pinned memory, fenced by an event), so the host
    compaction of chunk k runs while the device checks chunk k+1. On the CPU the chunks
    simply run one after the other.

    General (non-pipeline) surface:
    - normals (V, H, W, 3) + normal_thresh_deg < 360 enables the normal-angle
      consistency test (fusibile.cu:213-214); the return gains a third element,
      the averaged consistent normals (M, 3) float32.
    - depth_min/depth_max zero out-of-range depths before fusion. NOTE: the
      reference parses --depth_min/--depth_max (main.cpp:303-309) and converts them
      to disparity bounds (main.cpp:717-718), but the kernel consumers are commented
      out (fusibile.cu:364-365) — there they are inert; here they filter.
    - compact: 'auto' | 'always' | 'never'. Occupancy compaction: check only the VALID
      (depth > 0) reference pixels, as lists (as long as the longest of the chunk) made
      on the device, instead of the dense grid; the pipeline path's result is scattered
      back to the grid there, so the host sees one layout. It emits exactly the dense
      path's points in the dense path's order; 'auto' compacts a chunk whenever its
      lists are shorter than the grid.
    - timings: a dict that receives the seconds the call spent uploading, blocked on the
      device and the download, and compacting on the host, and the chunk counts.
    """
    device = resolve_device(device)
    V = depths.shape[0]
    if (cams is None) == (P_matrices is None):
        raise ValueError("pass exactly one of cams (V,2,4,4) or P_matrices (V,3,4)")
    if compact not in ("auto", "always", "never"):
        raise ValueError(f"compact must be auto/always/never, got {compact!r}")
    if P_matrices is not None:
        # generic-gipuma path: raw projection matrices from the KITTI/Strecha/
        # Middlebury readers (data/gipuma_io.py)
        P64 = np.asarray(P_matrices, np.float64)
        P, M_inv, centers, f, Minv64 = _geometry_from_P64(P64)
    else:
        P, M_inv, centers, f = camera_geometry(cams)
        cams64 = np.asarray(cams, np.float64)
        P64 = cams64[:, 1, :3, :3] @ cams64[:, 0, :3, :4]
        Minv64 = np.linalg.inv(P64[:, :, :3])
    depths = np.asarray(depths, np.float32)
    if depth_min is not None or depth_max is not None:
        lo = 0.0 if depth_min is None else float(depth_min)
        hi = np.inf if depth_max is None else float(depth_max)
        depths = np.where((depths >= lo) & (depths <= hi), depths, 0.0).astype(np.float32)

    from atvsnet_torch.native import compact_backproject, compact_points

    t0 = time.perf_counter()
    depths_d = torch.from_numpy(np.ascontiguousarray(depths)).to(device)
    images_d = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    P_d, Mi_d, C_d, f_d = (torch.from_numpy(a).to(device) for a in (P, M_inv, centers, f))
    normals_d = (None if normals is None
                 else torch.from_numpy(np.ascontiguousarray(normals, np.float32)).to(device))
    seconds = {"upload_s": time.perf_counter() - t0, "wait_s": 0.0, "compact_s": 0.0,
               "chunks": 0, "sparse_chunks": 0}

    R = max(1, min(int(ref_chunk), V))
    n_chunks = -(-V // R)
    H, W = depths.shape[1], depths.shape[2]
    hw = H * W
    # double-precision camera geometry for the host back-projection (the device keeps its
    # own fp32 copy for the checks; points are emitted from THIS side)
    P4_64 = P64[:, :, 3]

    # valid pixels per reference: what decides the path and the length of a chunk's lists
    valid_counts = (depths > 0).reshape(V, hw).sum(axis=1)

    def dispatch(ci):
        idxs = np.arange(ci * R, min(ci * R + R, V))
        idxs_d = torch.from_numpy(idxs).to(device)
        longest = max(int(valid_counts[idxs].max()), 1)
        use_sparse = compact == "always" or (compact == "auto" and longest < hw)
        pix_d = n_valid_d = None
        if use_sparse:
            # row-major lists, so that emitted points keep the dense path's order
            pix_d = valid_pixel_lists(depths_d, idxs_d, longest)
            n_valid_d = torch.from_numpy(valid_counts[idxs]).to(device)
        out = fuse_ref_chunk(
            idxs_d, pix_d, n_valid_d, depths_d, images_d, P_d, Mi_d, C_d, f_d,
            disp_thresh=float(disp_thresh), num_consistent=int(num_consistent),
            normals=normals_d, normal_thresh_rad=float(np.deg2rad(normal_thresh_deg)),
        )
        if use_sparse and normals is None:
            out = scatter_to_grid(out, pix_d, hw)
        seconds["chunks"] += 1
        seconds["sparse_chunks"] += int(use_sparse)
        outs = (out,) if normals is None else out
        return [start_download(o) for o in outs], idxs

    pts_out, rgb_out, nrm_out = [], [], []

    def pull(downloads, idxs):
        t0 = time.perf_counter()
        host = [finish_download(tensor, event) for tensor, event in downloads]
        t1 = time.perf_counter()
        seconds["wait_s"] += t1 - t0
        if normals is None:
            # ONE (R, hw, 4) uint8 array came down, from either path; one host function
            # compacts it and back-projects world coordinates from the host-resident
            # (filtered) depth maps: the same bits in the same order for both paths
            packed = host[0]
            for j, r in enumerate(idxs):
                pts, cols = compact_backproject(packed[j], depths[r], Minv64[r], P4_64[r])
                if pts.shape[0]:
                    pts_out.append(pts)
                    rgb_out.append(cols)
        else:
            # generic gipuma surface (normals requested): emit/X/rgb/normals come down and
            # are compacted on the host (non-finite coordinates zeroed per
            # displayUtils.h:113-118), whether the pixel axis is the grid or the lists
            # (valid pixels first, in row-major order; what follows them never emits)
            emit_np, X_np, rgb_np, nrm_np = host
            pts, cols = compact_points(emit_np, X_np, rgb_np)
            if pts.shape[0]:
                pts_out.append(pts)
                rgb_out.append(cols)
                # same row-major order as the compaction
                nrm_out.append(nrm_np.reshape(-1, 3)[emit_np.reshape(-1).astype(bool)])
        seconds["compact_s"] += time.perf_counter() - t1

    pending = dispatch(0)
    for ci in range(1, n_chunks):
        nxt = dispatch(ci)      # the device starts chunk ci while the host compacts
        pull(*pending)
        pending = nxt
    pull(*pending)
    if timings is not None:
        timings.update(seconds)
    if not pts_out:
        z3 = np.zeros((0, 3), np.float32)
        if normals is not None:
            return z3, np.zeros((0, 3), np.uint8), z3.copy()
        return z3, np.zeros((0, 3), np.uint8)
    if normals is not None:
        return np.concatenate(pts_out), np.concatenate(rgb_out), np.concatenate(nrm_out)
    return np.concatenate(pts_out), np.concatenate(rgb_out)
