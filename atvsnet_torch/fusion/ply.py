"""Binary little-endian PLY point cloud writer and reader (the port's copy of
atvsnet_tpu/fusion/ply.py).

Format matches reference fusibile/displayUtils.h:80-136: xyz float32 + RGB uchar
(normals commented out there too).
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    points = np.asarray(points, "<f4")
    colors = np.asarray(colors, np.uint8)
    if points.ndim != 2 or points.shape[1] != 3 or points.shape != colors.shape:
        raise ValueError(f"points {points.shape} and colors {colors.shape} must both be (n, 3)")
    from atvsnet_torch import native

    native.write_ply(path, points, colors)


def read_ply(path: str):
    """Minimal reader for the format written above (for tests/round-trips)."""
    with open(path, "rb") as f:
        n = None
        while True:
            raw = f.readline()
            if not raw:  # EOF before end_header: truncated / not a PLY
                raise ValueError(f"no end_header in PLY file: {path!r}")
            line = raw.decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        rec = np.fromfile(f, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
    return rec["xyz"].copy(), rec["rgb"].copy()
