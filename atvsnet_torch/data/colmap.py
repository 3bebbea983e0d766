"""COLMAP text-model data path (reference atvsnet/colmap_helpers.py +
preprocess_colmap.py:168-257); the port's copy of atvsnet_tpu/data/colmap.py, numpy only.

Parses sparse COLMAP reconstructions (images.txt quaternion extrinsics, cameras.txt
intrinsics, points3D.txt), estimates per-image inverse-depth sweep ranges from the
sparse points (percentile 0.99 stretched by 4/3), selects neighbor views by shared-3D-
point count with an index-adjacency fallback, and assembles MVSNet-convention (2,4,4)
cameras. No pyquaternion dependency — quaternions are converted directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np


def quaternion_to_rotation(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Hamilton-convention unit quaternion -> 3x3 rotation (COLMAP images.txt order)."""
    q = np.array([qw, qx, qy, qz], dtype=np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclasses.dataclass
class ColmapCamera:
    id: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass
class ColmapImage:
    id: int
    extrinsic: np.ndarray            # 4x4 world->cam
    camera_id: int
    filename: str
    point_ids: set                   # visible 3D point ids
    neighbor_list: List[int] = dataclasses.field(default_factory=list)
    estimated_max_disparity: Optional[float] = None
    estimated_min_disparity: Optional[float] = None


def _data_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("#")]


def parse_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in _data_lines(path):
        w = line.split()
        if not w:
            continue
        cid = int(w[0])
        model = w[1]
        width, height = int(w[2]), int(w[3])
        p = [float(v) for v in w[4:]]
        # PINHOLE: fx fy cx cy; SIMPLE_PINHOLE/SIMPLE_RADIAL: f cx cy [k]
        if model in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        else:
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        cams[cid] = ColmapCamera(cid, width, height, fx, fy, cx, cy)
    return cams


def parse_images_txt(path: str) -> Dict[int, ColmapImage]:
    images = {}
    lines = _data_lines(path)
    # alternating: image line, 2D-points line
    for i in range(0, len(lines) - 1, 2):
        w = lines[i].split()
        if not w:
            continue
        img_id = int(w[0])
        R = quaternion_to_rotation(float(w[1]), float(w[2]), float(w[3]), float(w[4]))
        t = np.array([float(w[5]), float(w[6]), float(w[7])])
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = t
        cam_id = int(w[8])
        name = w[9]
        pw = lines[i + 1].split()
        point_ids = {
            int(pw[3 * k + 2]) for k in range(len(pw) // 3) if int(pw[3 * k + 2]) != -1
        }
        images[img_id] = ColmapImage(img_id, E, cam_id, name, point_ids)
    return images


def parse_points3d_txt(path: str) -> Dict[int, np.ndarray]:
    points = {}
    for line in _data_lines(path):
        w = line.split()
        if not w:
            continue
        points[int(w[0])] = np.array([float(w[1]), float(w[2]), float(w[3]), 1.0])
    return points


class ColmapSparse:
    """Sparse model + per-image disparity ranges + neighbor lists.

    Mirrors reference ColmapSparse (colmap_helpers.py:255-371).
    """

    def __init__(
        self,
        sparse_path: str,
        image_path: str,
        num_neighbors: int = 9,
        with_points: bool = True,
    ):
        self.cameras = parse_cameras_txt(os.path.join(sparse_path, "cameras.txt"))
        self.images = parse_images_txt(os.path.join(sparse_path, "images.txt"))
        self.points = (
            parse_points3d_txt(os.path.join(sparse_path, "points3D.txt"))
            if with_points and os.path.exists(os.path.join(sparse_path, "points3D.txt"))
            else {}
        )
        for img in self.images.values():
            img.filepath = os.path.join(image_path, img.filename)
        if self.points:
            self.estimate_disparities()
        self.generate_neighbor_list(num_neighbors)

    def estimate_disparities(self, percentile: float = 0.99, stretch: float = 4.0 / 3.0):
        """Per-image inverse-depth range from visible sparse points
        (colmap_helpers.py:317-331: sort, take 99th percentile x 1.333 and 1st / 1.333)."""
        pts = np.stack(list(self.points.values()))  # (P, 4)
        for img in self.images.values():
            cam = self.cameras[img.camera_id]
            coord = pts @ img.extrinsic[:3].T       # (P, 3) camera-frame
            z = coord[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                x = coord[:, 0] / z * cam.fx + cam.cx
                y = coord[:, 1] / z * cam.fy + cam.cy
                d = 1.0 / z
            ok = (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height) & (d > 0)
            disp = np.sort(d[ok])
            if disp.size == 0:
                continue
            img.estimated_max_disparity = float(disp[int(disp.size * percentile)] * stretch)
            img.estimated_min_disparity = float(
                disp[int(disp.size * (1.0 - percentile))] / stretch
            )

    def generate_neighbor_list(self, num_neighbors: int):
        """Rank neighbors by shared-3D-point count; pad by index adjacency
        (colmap_helpers.py:333-371)."""
        ids = list(self.images.keys())
        for ref_id in ids:
            ref = self.images[ref_id]
            shared = [
                0 if nid == ref_id else len(ref.point_ids & self.images[nid].point_ids)
                for nid in ids
            ]
            order = np.argsort(np.array(shared))[::-1]
            neighbors: List[int] = []
            for idx in order:
                if shared[idx] == 0:
                    break
                neighbors.append(ids[idx])
                if len(neighbors) == num_neighbors:
                    break
            if len(neighbors) < num_neighbors:
                i = 1
                while len(neighbors) < num_neighbors and i <= 10 * num_neighbors:
                    for cand in (ref_id + i, ref_id - i):
                        if cand in self.images and cand != ref_id and cand not in neighbors:
                            neighbors.append(cand)
                    i += 1
            ref.neighbor_list = neighbors[:num_neighbors]


def colmap_cam_to_mvsnet(
    sparse: ColmapSparse,
    img_id: int,
    max_d: int = 128,
    inverse_depth: bool = True,
) -> np.ndarray:
    """Assemble the (2,4,4) camera with a sweep row from estimated disparities
    (reference preprocess_colmap.py:168-236)."""
    img = sparse.images[img_id]
    caminfo = sparse.cameras[img.camera_id]
    cam = np.zeros((2, 4, 4))
    cam[0] = img.extrinsic
    cam[1][0][0] = caminfo.fx
    cam[1][1][1] = caminfo.fy
    cam[1][0][2] = caminfo.cx
    cam[1][1][2] = caminfo.cy
    cam[1][2][2] = 1.0

    max_disp = img.estimated_max_disparity
    min_disp = img.estimated_min_disparity
    if inverse_depth:
        depth_min = 0.0 if min_disp is None else float(min_disp)
        if max_disp is None or float(max_disp) <= depth_min:
            depth_interval = 0.02
        else:
            depth_interval = (float(max_disp) - depth_min) / float(max_d - 1)
    else:
        depth_min = 0.8 if max_disp is None else 1.0 / float(max_disp)
        if min_disp is None or (1.0 / float(min_disp)) <= depth_min:
            depth_interval = 0.02
        else:
            depth_interval = (1.0 / float(min_disp) - depth_min) / float(max_d - 1)
    cam[1][3][0] = depth_min
    cam[1][3][1] = depth_interval
    cam[1][3][2] = max_d
    cam[1][3][3] = depth_min + depth_interval * max_d
    return cam


def colmap_sample_paths(sparse: ColmapSparse, ref_id: int, view_num: int):
    """[ref, neighbors...] image ids for one inference sample."""
    neighbors = sparse.images[ref_id].neighbor_list[: view_num - 1]
    return [ref_id] + neighbors


def set_depth_range_from_depthmap(
    cams: np.ndarray,
    depthmap: np.ndarray,
    max_d: int,
    interval_scale: float = 1.0,
    percentile: float = 0.95,
    stretch: float = 1.3,
) -> np.ndarray:
    """Override all views' sweep rows from a GT depth map
    (reference preprocess_colmap.py:238-257)."""
    d = depthmap.flatten()
    d = np.sort(d[(d < 1e10) & (d > 0.0)])
    depth_max = d[int(len(d) * percentile)] * stretch
    depth_min = d[int(len(d) * (1.0 - percentile))] / stretch
    depth_interval = (depth_max - depth_min) * interval_scale / float(max_d - 1)
    cams = np.copy(cams)
    for view in range(cams.shape[0]):
        cams[view][1, 3, 0] = depth_min
        cams[view][1, 3, 1] = depth_interval
    return cams
