"""Gipuma .dmb binary image format and Strecha .P projection files.

The port's copy of atvsnet_tpu/fusion/dmb.py: compatibility shims for the fusibile
on-disk interface (reference depth_fusion.py:24-90, fusibile/fileIoUtils.h:83,250-333).
The in-process fusion does not need them; they let fuse.export_gipuma write
gipuma-format artifacts.

.dmb layout: 4 int32 LE (type=1, height, width, channels) then float32 data stored
column-major as (width, height, channels).
"""

from __future__ import annotations

import struct

import numpy as np


def read_dmb(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        _type, height, width, channels = struct.unpack("<iiii", f.read(16))
        data = np.fromfile(f, np.float32)
    arr = data.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_dmb(path: str, image: np.ndarray) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    height, width, channels = image.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, height, width, channels))
        # reference writes np.transpose(image, (2, 0, 1)) C-order == (W,H,C) F-order
        np.transpose(image, (2, 0, 1)).astype(np.float32).tofile(f)


def write_p_matrix(path: str, P: np.ndarray) -> None:
    """Strecha-style 3x4 .P text file (reference depth_fusion.py:82-88)."""
    P = np.asarray(P)
    with open(path, "w") as f:
        for i in range(3):
            f.write(" ".join(str(P[i][j]) for j in range(4)) + " \n")
        f.write("\n")


def read_p_matrix(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    return np.asarray(vals[:12], np.float64).reshape(3, 4)


def fake_normals(depth_image: np.ndarray) -> np.ndarray:
    """Unit (1,1,1)/sqrt(3) normals masked by depth>0 (reference depth_fusion.py:92-111)."""
    h, w = depth_image.shape[:2]
    normal = np.full((h, w, 3), 1.0 / 1.732050808, np.float32)
    mask = (np.asarray(depth_image).reshape(h, w, -1)[..., 0] > 0).astype(np.float32)
    return normal * mask[..., None]
