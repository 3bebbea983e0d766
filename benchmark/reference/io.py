"""Readers of the files that a run writes and reads: PFM maps, MVSNet cam texts, pair
lists and binary PLY clouds (the formats of the reference implementation's
atvsnet/preprocess.py and fusibile's displayUtils.h)."""

from __future__ import annotations

import os
import re

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        width, height = map(int, re.match(r"^\s*(\d+)\s+(\d+)\s*$",
                                          f.readline().decode("latin-1")).groups())
        scale = float(f.readline().decode("latin-1").rstrip())
        data = np.frombuffer(f.read(), dtype="<f" if scale < 0 else ">f")
    shape = (height, width, 3) if header == "PF" else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, image: np.ndarray) -> None:
    image = np.asarray(image, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n" if image.ndim == 2 else b"PF\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n-1.0\n".encode())
        np.flipud(image).astype("<f4").tofile(f)


def read_cam(path: str, max_d: int = 128) -> np.ndarray:
    """(2, 4, 4) float64: extrinsic, intrinsic, and the depth row [start, interval,
    planes, end] completed from 2, 3 or 4 values."""
    words = open(path).read().split()
    cam = np.zeros((2, 4, 4))
    cam[0] = np.array(words[1:17], float).reshape(4, 4)
    cam[1, :3, :3] = np.array(words[18:27], float).reshape(3, 3)
    row = [float(w) for w in words[27:31]]
    cam[1, 3, 0], cam[1, 3, 1] = row[0], row[1]
    cam[1, 3, 2] = row[2] if len(row) > 2 else max_d
    cam[1, 3, 3] = row[3] if len(row) > 3 else row[0] + row[1] * cam[1, 3, 2]
    return cam


def write_cam(path: str, cam: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0][i][j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1][i][j]) for j in range(3)) + " \n")
        f.write("\n" + " ".join(str(cam[1][3][j]) for j in range(4)) + "\n")


def read_pairs(scene_dir: str, view_num: int) -> list:
    """pair.txt -> per reference image [(image path, cam path)] of the reference and its
    first view_num - 1 neighbours."""
    words = open(os.path.join(scene_dir, "pair.txt")).read().split()
    out, pos = [], 1
    for _ in range(int(words[0])):
        ref, n = int(words[pos]), int(words[pos + 1])
        views = [ref] + [int(words[pos + 2 + 2 * i]) for i in range(min(view_num - 1, n))]
        pos += 2 + 2 * n
        out.append([(os.path.join(scene_dir, "images", f"{v:08d}.jpg"),
                     os.path.join(scene_dir, "cams", f"{v:08d}_cam.txt")) for v in views])
    return out


def read_ply(path: str) -> np.ndarray:
    """The (n, 3) float32 points of a binary little-endian xyz + rgb PLY."""
    with open(path, "rb") as f:
        n = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"no end_header in {path}")
            line = line.decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        rec = np.fromfile(f, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
    return rec["xyz"].copy()
