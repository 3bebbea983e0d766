"""MVS-Synth / DeMoN sequence dataset path (reference atvsnet/mvs_syn_helpers.py +
preprocess_mvs_syn.py); the port of atvsnet_tpu/data/mvs_syn.py.

Here: SeqImage, MvsSynDataset (neighbor selection, samples, the train/val split), the
EXR depth reader and load_training_sample, which builds a training batch.

Layout: <base>/<seq:04d>/{images/%04d.png, poses/%04d.json, depths/%04d.exr,
neighbors/%04d.json [+ %04d_score.json]} with <base>/num_images.json listing sequence
lengths. Poses carry f_x/f_y/c_x/c_y and a 4x4 world->cam 'extrinsic'.

Neighbor selection (mvs_syn_helpers.py:168-313): prefer the precomputed
depth-reprojection neighbor files with score-threshold decay (start 0.6, x0.8 down to
0.2, keep scores above threshold; reject refs whose valid-depth ratio < 0.2), else fall
back to all same-sequence views within a 60-degree central-ray angle; window to the
max_neighbor_range closest and emit shuffled permutations of size num_neighbors.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from atvsnet_torch.data import image_io
from atvsnet_torch.data.augment import augment_image_group
from atvsnet_torch.data.colmap import set_depth_range_from_depthmap
from atvsnet_torch.geometry.cameras import scale_camera_np

DEMON_TRAIN_SETS = [
    # reference preprocess_mvs_syn.py:404-409
    "mvs_achteck_turm", "mvs_breisach", "mvs_citywall",
    "rgbd_10_to_20_3d_train", "rgbd_10_to_20_handheld_train",
    "rgbd_10_to_20_simple_train", "rgbd_20_to_inf_3d_train",
    "rgbd_20_to_inf_handheld_train", "rgbd_20_to_inf_simple_train",
    "scenes11_train", "sun3d_train_0.01m_to_0.1m", "sun3d_train_0.1m_to_0.2m",
    "sun3d_train_0.2m_to_0.4m", "sun3d_train_0.4m_to_0.8m",
    "sun3d_train_0.8m_to_1.6m", "sun3d_train_1.6m_to_infm", "sun3d_train",
    "mvs_synth",
]


@dataclasses.dataclass
class SeqImage:
    id: int
    seq_id: int
    img_id: int
    extrinsic: np.ndarray
    filepath: str
    depthpath: str
    fx: float
    fy: float
    cx: float
    cy: float
    neighbor_permutations: Optional[List[List[int]]] = None
    is_valid: bool = True

    @property
    def view_vec(self) -> np.ndarray:
        """Central viewing ray in world frame (mvs_syn_helpers.py:38-46)."""
        K_inv = np.linalg.inv(
            np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]])
        )
        R_c2w = self.extrinsic[:3, :3].T
        v = R_c2w @ K_inv @ np.array([self.cx, self.cy, 1.0])
        return v / (np.linalg.norm(v) + 1e-10)

    def to_mvsnet_cam(self, max_d: int = 128) -> np.ndarray:
        cam = np.zeros((2, 4, 4))
        cam[0] = self.extrinsic
        cam[1][0][0] = self.fx
        cam[1][1][1] = self.fy
        cam[1][0][2] = self.cx
        cam[1][1][2] = self.cy
        cam[1][2][2] = 1.0
        cam[1][3][2] = max_d
        return cam


class MvsSynDataset:
    def __init__(
        self,
        basepath: str,
        num_neighbors: int = 9,
        max_neighbor_range: int = 5,
        seed: int = 0,
    ):
        self.basepath = basepath
        with open(os.path.join(basepath, "num_images.json")) as f:
            self.num_images = np.array(json.load(f))
        self.rng = np.random.RandomState(seed)

        self.images: List[SeqImage] = []
        self.by_seq = {}
        count = 0
        for seq_idx, n in enumerate(self.num_images):
            if n < 2:
                continue
            seq_dir = os.path.join(basepath, f"{seq_idx:04d}")
            for img_idx in range(int(n)):
                with open(os.path.join(seq_dir, "poses", f"{img_idx:04d}.json")) as f:
                    info = json.load(f)
                img = SeqImage(
                    id=count,
                    seq_id=seq_idx,
                    img_id=img_idx,
                    extrinsic=np.array(info["extrinsic"], dtype=np.float64),
                    filepath=os.path.join(seq_dir, "images", f"{img_idx:04d}.png"),
                    depthpath=os.path.join(seq_dir, "depths", f"{img_idx:04d}.exr"),
                    fx=info["f_x"], fy=info["f_y"], cx=info["c_x"], cy=info["c_y"],
                )
                self.images.append(img)
                self.by_seq[(seq_idx, img_idx)] = count
                count += 1
        self._generate_neighbors(num_neighbors, max_neighbor_range)

    # ------------------------------------------------------------------
    def _file_neighbors(self, ref: SeqImage):
        """Precomputed neighbor ids + score-threshold decay; None if no file."""
        seq_dir = os.path.join(self.basepath, f"{ref.seq_id:04d}", "neighbors")
        neigh_path = os.path.join(seq_dir, f"{ref.img_id:04d}.json")
        if not os.path.isfile(neigh_path):
            return None
        with open(neigh_path) as f:
            neighbors = np.array(json.load(f))
        if neighbors.size == 0:
            return np.array([], dtype=int)

        score_path = os.path.join(seq_dir, f"{ref.img_id:04d}_score.json")
        if os.path.isfile(score_path):
            with open(score_path) as f:
                payload = json.load(f)
            scores = np.array(payload[0])
            valid_depth_ratio = payload[1]
            if valid_depth_ratio < 0.2:
                return np.array([], dtype=int)
            thres = 0.6
            min_left = min(len(neighbors), self._num_neighbors)
            while np.sum(scores > thres) < min_left and thres > 0.2:
                thres *= 0.8
            neighbors = neighbors[scores > thres]
        return neighbors.astype(int)

    def _angle_neighbors(self, ref: SeqImage, max_angle_deg: float = 60.0):
        out = []
        ref_vec = ref.view_vec
        for img_id in range(int(self.num_images[ref.seq_id])):
            if img_id == ref.img_id:
                continue
            idx = self.by_seq.get((ref.seq_id, img_id))
            if idx is None:
                continue
            ang = np.arccos(np.clip(ref_vec @ self.images[idx].view_vec, -1, 1))
            if 0.0 < ang < np.deg2rad(max_angle_deg):
                out.append(self.images[idx].img_id)
        return np.array(out, dtype=int)

    def _generate_neighbors(self, num_neighbors: int, max_range: int):
        self._num_neighbors = num_neighbors
        for ref in self.images:
            from_file = self._file_neighbors(ref)
            if from_file is not None and from_file.size == 0:
                ref.neighbor_permutations = [[ref.id] * num_neighbors]
                ref.is_valid = False
                continue
            ids = from_file if from_file is not None else self._angle_neighbors(ref)
            if len(ids) > max_range:
                # window of max_range candidates AROUND the ref's position in the
                # (ascending-id) candidate list, clamped at the ends — the
                # reference's selection (mvs_syn_helpers.py:262-274); a plain
                # [:max_range] would take the sequence's first frames for late refs
                pos = int(np.argmin(np.abs(np.asarray(ids) - ref.img_id)))
                if pos < max_range / 2:
                    start = 0
                elif pos > len(ids) - max_range / 2:
                    start = len(ids) - max_range
                else:
                    start = max(0, pos - max_range // 2)
                ids = ids[start : start + max_range]
            cand = [self.by_seq[(ref.seq_id, i)] for i in ids if (ref.seq_id, i) in self.by_seq]
            if len(cand) < num_neighbors:
                ref.neighbor_permutations = None
                ref.is_valid = False
                continue
            num_permute = int(np.ceil(len(cand) / num_neighbors))
            perms = []
            pool = np.array(cand)
            for _ in range(num_permute):
                self.rng.shuffle(pool)
                perms.append([self.images[i].id for i in pool[:num_neighbors]])
            ref.neighbor_permutations = perms

    # ------------------------------------------------------------------
    def samples(self, view_num: int):
        """Yield [ref_id, neighbor ids...] lists for every valid ref/permutation."""
        for ref in self.images:
            if not ref.is_valid or not ref.neighbor_permutations:
                continue
            for perm in ref.neighbor_permutations:
                yield [ref.id] + list(perm[: view_num - 1])

    def training_samples(self, view_num: int, mode: str = "training", augment_number: int = 1):
        """Train/val-split samples with augment repeats (preprocess_mvs_syn.py:436-476).

        val.json at the dataset root lists validation sequence ids; absent -> all
        samples are training. Yields (ids, augment_index)."""
        val_path = os.path.join(self.basepath, "val.json")
        val_seqs = set()
        if os.path.isfile(val_path):
            with open(val_path) as f:
                val_seqs = set(json.load(f))
        for ids in self.samples(view_num):
            seq = self.images[ids[0]].seq_id
            if mode == "training" and seq in val_seqs:
                continue
            if mode == "validation" and seq not in val_seqs:
                continue
            for aug in range(augment_number):
                yield ids, aug


def load_training_sample(
    dataset: "MvsSynDataset",
    ids,
    max_d: int = 128,
    sample_scale: float = 0.25,
    inverse_depth: bool = True,
    augment_rng=None,
    multi_depth: bool = False,
):
    """Read one [ref, views...] sample: images + EXR GT depth -> training batch.

    Returns dict(images (1,N,H,W,3), cams (1,N,2,4,4), depth_gt (1,h,w,1) in sweep space
    at cost-volume resolution). The depth range comes from the GT depth map (reference
    eval_pointcloud.py:172-193 / preprocess_colmap.py:238-257).

    multi_depth=True also loads every neighbor view's own-frame GT depth (the reference's
    gen_mvs_resized_path_multi_depth layout, preprocess_mvs_syn.py:485-582) as
    depth_views_gt (1, N-1, h, w, 1), which training_loss then supervises the per-pair
    swapped depths with directly.
    """
    imgs = augment_image_group([image_io.imread(dataset.images[i].filepath) for i in ids],
                               rng=augment_rng)
    cams = np.stack([dataset.images[i].to_mvsnet_cam(max_d) for i in ids])

    ref = dataset.images[ids[0]]
    depth = _read_exr_depth(ref.depthpath)
    if not (depth > 0).any():
        # e.g. a sky-only frame whose EXR is all inf/0: the angle-fallback neighbors have no
        # valid-depth screen, and an empty range source would fail deep in the range code
        raise ValueError(f"no valid GT depth pixels in {ref.depthpath!r}")
    rng_src = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-10), 0.0) if inverse_depth else depth
    cams = set_depth_range_from_depthmap(cams, rng_src, max_d)
    cams = np.stack([scale_camera_np(c, sample_scale) for c in cams])

    h = int(depth.shape[0] * sample_scale)
    w = int(depth.shape[1] * sample_scale)

    def to_sweep_small(d):
        small = image_io.resize_to(d.astype(np.float32), w, h, "nearest")
        if inverse_depth:
            small = np.where(small > 0, 1.0 / np.maximum(small, 1e-10), 0.0)
        return small

    out = {
        "images": np.stack(imgs)[None].astype(np.float32),
        "cams": cams[None].astype(np.float32),
        "depth_gt": to_sweep_small(depth)[None, ..., None].astype(np.float32),
    }
    if multi_depth:
        view_gt = [to_sweep_small(_read_exr_depth(dataset.images[i].depthpath)) for i in ids[1:]]
        out["depth_views_gt"] = np.stack(view_gt)[None, ..., None].astype(np.float32)
    return out


def _read_exr_depth(path: str) -> np.ndarray:
    """Read an EXR depth map (first channel) through data.image_io, the port's only codec
    door; a file that cannot be decoded raises IOError naming the path."""
    return image_io.imread_depth(path)
