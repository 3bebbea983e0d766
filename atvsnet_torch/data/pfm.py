"""PFM image I/O (reference atvsnet/preprocess.py:162-224; the port's copy of
atvsnet_tpu/data/pfm.py, numpy only).

PFM stores rows bottom-to-top; negative scale marks little-endian.
"""

from __future__ import annotations

import re
from typing import Union

import numpy as np


def load_pfm(path_or_file) -> np.ndarray:
    close = False
    if isinstance(path_or_file, (str, bytes)):
        f = open(path_or_file, "rb")
        close = True
    else:
        f = path_or_file
    try:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_line = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dim_line)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("latin-1").rstrip())
        dtype = "<f" if scale < 0 else ">f"
        data = np.frombuffer(f.read(), dtype=dtype)
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape)).copy()
    finally:
        if close:
            f.close()


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image)
    if image.dtype.name != "float32":
        image = image.astype(np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must be HxW, HxWx1 or HxWx3.")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        # numpy native little-endian -> negative scale
        f.write(f"{-abs(scale)}\n".encode())
        np.flipud(image).astype("<f4").tofile(f)
