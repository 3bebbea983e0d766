"""The published weights as the reference's dict of tensors.

The .npz holds the flat '/'-keyed tree of the reference implementation in TensorFlow's
layouts: a conv kernel (k..., in, out), a transposed conv kernel (k..., out, in). Both
become PyTorch's weight layout by one permutation: (out, in, k...) for F.conv*d and
(in, out, k...) for F.conv_transpose*d. Vectors stay as they are.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_weights(path: str, device) -> dict:
    """{name: float32 tensor on `device`} in PyTorch's layouts."""
    out = {}
    with np.load(path) as z:
        for name in z.files:
            t = torch.from_numpy(np.array(z[name], np.float32))
            if t.ndim > 2:
                nd = t.ndim - 2
                t = t.permute(nd + 1, nd, *range(nd)).contiguous()
            out[name] = t.to(device)
    return out
