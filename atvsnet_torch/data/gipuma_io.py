"""Generic gipuma-stereo file readers + projection-matrix camera path (the port's copy
of atvsnet_tpu/data/gipuma_io.py, numpy only).

The reference's fusibile binary accepts cameras from several dataset formats
beyond the pipeline's MVSNet cam.txt: KITTI calib files, Strecha/PMVS per-view
P-matrix files, and Middlebury K/R/t tables (fusibile/fileIoUtils.h:44-153),
all funneled into raw 3x4 projection matrices that
cameraGeometryUtils.h:318-331 then decomposes into K/R/C with OpenCV's
decomposeProjectionMatrix. This module is the equivalent surface: small host
parsers (no OpenCV dependency — the RQ decomposition is ~10 lines of numpy)
producing (V, 3, 4) float64 P stacks that `fusion.consistency.fuse_depth_maps`
consumes directly via its `P_matrices=` input.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = [
    "decompose_projection",
    "read_kitti_calib",
    "read_strecha_camera",
    "read_pmvs_p_file",
    "read_middlebury_krt",
]


def decompose_projection(P: np.ndarray):
    """P (3, 4) -> (K (3,3), R (3,3), t (3,)) with P ~ K @ [R | t].

    RQ decomposition with the diagonal of K forced positive and K normalized to
    K[2,2] = 1 — the same convention as OpenCV's decomposeProjectionMatrix,
    which the reference runs per camera (cameraGeometryUtils.h:319). The
    camera center is -R.T @ t (cf. the C = T[:3]/T[3] step at
    cameraGeometryUtils.h:326-327).
    """
    P = np.asarray(P, np.float64)
    if P.shape != (3, 4):
        raise ValueError(f"projection matrix must be (3, 4), got {P.shape}")
    M = P[:, :3]
    # RQ via QR of the row-reversed transpose
    rev = np.eye(3)[::-1]
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    # force positive diagonal on K (D is its own inverse)
    D = np.diag(np.sign(np.diag(K)))
    K = K @ D
    R = D @ R
    # proper rotation (det +1); the paired sign flips keep K @ R == M, i.e. a
    # global sign flip of P leaves the decomposition consistent
    if np.linalg.det(R) < 0:
        R = -R
        K = -K
    t = np.linalg.solve(K, P[:, 3])
    scale = K[2, 2]
    if scale == 0:
        raise ValueError("degenerate projection matrix (K[2,2] == 0)")
    K = K / scale
    return K, R, t


def _parse_projection_line(line: str) -> np.ndarray:
    """Whitespace-separated floats -> (3, 4); tokens starting with P/p (the
    'P0:' label) are skipped, exactly like fileIoUtils.h:10-25."""
    vals = [float(tok) for tok in line.split() if tok[0] not in "Pp"]
    if len(vals) < 12:
        raise ValueError(f"projection line has {len(vals)} values, need 12")
    return np.asarray(vals[:12], np.float64).reshape(3, 4)


def read_kitti_calib(path: str):
    """KITTI calib file -> (P0, P1) rectified projection matrices, (3, 4) each
    (fileIoUtils.h:44-54: the first two lines)."""
    with open(path) as f:
        p0 = _parse_projection_line(f.readline())
        p1 = _parse_projection_line(f.readline())
    return p0, p1


def read_strecha_camera(path: str) -> float:
    """Strecha .camera file -> focal length in pixels (alpha_x, the first value
    of the internal camera matrix — fileIoUtils.h:71-81 reads only this)."""
    with open(path) as f:
        return float(f.readline().split()[0])


def read_pmvs_p_file(path: str) -> np.ndarray:
    """Strecha/PMVS txt P-file -> (3, 4) projection matrix; a leading CONTOUR
    header line is skipped (fileIoUtils.h:83-110)."""
    rows = []
    with open(path) as f:
        for line in f:
            if "CONTOUR" in line or not line.strip():
                continue
            rows.append([float(tok) for tok in line.split()])
            if len(rows) == 3:
                break
    if len(rows) < 3:
        raise ValueError(f"{path}: expected 3 projection rows")
    return np.asarray(rows, np.float64)


def read_middlebury_krt(path: str, image_names: Sequence[str]) -> np.ndarray:
    """Middlebury K/R/t table -> (V, 3, 4) P stack aligned to image_names.

    Format (fileIoUtils.h:111-152): first line is a count (thrown away), then
    one line per image: name k11..k33 r11..r33 t1 t2 t3; P = K @ [R | t],
    matched to the caller's image list by name.
    """
    by_name = {}
    with open(path) as f:
        f.readline()
        for line in f:
            toks = line.split()
            if len(toks) < 22:
                continue
            name = toks[0]
            vals = np.asarray([float(v) for v in toks[1:22]], np.float64)
            K = vals[0:9].reshape(3, 3)
            R = vals[9:18].reshape(3, 3)
            t = vals[18:21]
            by_name[name] = K @ np.concatenate([R, t[:, None]], axis=1)
    try:
        return np.stack([by_name[n] for n in image_names])
    except KeyError as e:
        raise KeyError(f"image {e} not present in {os.path.basename(path)}") from e
