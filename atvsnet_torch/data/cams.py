"""MVSNet-format camera text files and the (2,4,4) npy camera convention (the port's
copy of atvsnet_tpu/data/cams.py, numpy only).

Reference: atvsnet/preprocess.py:102-160. The text layout is
  'extrinsic' + 16 floats (row-major 4x4), 'intrinsic' + 9 floats (3x3),
  then a depth line with 2-4 values [start, interval[, num_d[, end]]].
Word counts 29/30/31 select how the depth row is completed.
"""

from __future__ import annotations

import numpy as np


def load_cam_text(text: str, interval_scale: float = 1.0, max_d: int = 128) -> np.ndarray:
    cam = np.zeros((2, 4, 4), dtype=np.float64)
    words = text.split()
    for i in range(4):
        for j in range(4):
            cam[0][i][j] = float(words[4 * i + j + 1])
    for i in range(3):
        for j in range(3):
            cam[1][i][j] = float(words[3 * i + j + 18])

    n = len(words)
    if n == 29:
        cam[1][3][0] = float(words[27])
        cam[1][3][1] = float(words[28]) * interval_scale
        cam[1][3][2] = max_d
        cam[1][3][3] = cam[1][3][0] + cam[1][3][1] * cam[1][3][2]
    elif n == 30:
        cam[1][3][0] = float(words[27])
        cam[1][3][1] = float(words[28]) * interval_scale
        cam[1][3][2] = float(words[29])
        cam[1][3][3] = cam[1][3][0] + cam[1][3][1] * cam[1][3][2]
    elif n == 31:
        cam[1][3][0] = float(words[27])
        cam[1][3][1] = float(words[28]) * interval_scale
        cam[1][3][2] = float(words[29])
        cam[1][3][3] = float(words[30])
    return cam


def load_cam(path: str, interval_scale: float = 1.0, max_d: int = 128) -> np.ndarray:
    with open(path) as f:
        return load_cam_text(f.read(), interval_scale, max_d)


def write_cam(path: str, cam: np.ndarray) -> None:
    """Write MVSNet cam.txt (reference preprocess.py:141-160)."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0][i][j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1][i][j]) for j in range(3)) + " \n")
        f.write(
            "\n"
            + " ".join(str(cam[1][3][j]) for j in range(4))
            + "\n"
        )


def projection_matrix(cam: np.ndarray) -> np.ndarray:
    """3x4 P = K[:3,:3] @ extrinsic[:3,:] (reference depth_fusion.py:68-90)."""
    intrinsic = np.array(cam[1], dtype=np.float64)
    intrinsic[3, :] = 0.0
    K4 = np.eye(4)
    K4[:3, :3] = intrinsic[:3, :3]
    P = K4 @ np.asarray(cam[0], dtype=np.float64)
    return P[:3, :]
