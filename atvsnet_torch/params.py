"""Weight bridge: the JAX package's parameter tree <-> the port's ATVSNet module.

The JAX tree is a nested dict, or the flat '/'-keyed dict that atvsnet_tpu's
utils/ckpt.save_params writes to .npz (e.g. artifacts/trained_demo/spheres_params.npz).
Its path fem/conv0_x_0/conv1/w is the parameter fem.conv0_x_0.conv1.w here.

Layouts: a conv kernel TF (k..., in, out) becomes PyTorch's (out, in, k...); a
transpose-conv kernel TF (k..., out, in) becomes conv_transpose's (in, out, k...). Both
are the same permutation (layers.tf_to_torch). Biases and betas are copied as they are.

init_model (models/tvsnet.py) builds a model with random weights from a seeded
torch.Generator, for callers that have no parameter file; its draws are not the JAX
package's init_params draws.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from atvsnet_torch import resolve_device
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models.tvsnet import ATVSNet, init_model
from atvsnet_torch.nn.layers import tf_to_torch, torch_to_tf

__all__ = ["export_jax_params", "flatten", "init_model", "load_jax_params", "load_model",
           "load_npz", "save_params"]


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested or flat dict of arrays -> flat {'a/b/c': np.ndarray}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def load_npz(path: str) -> dict:
    """Flat '/'-keyed parameter dict from an .npz saved by the JAX package."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_jax_params(model: ATVSNet, tree: Mapping) -> ATVSNet:
    """Copy a JAX parameter tree into `model` (strict: every key and shape must match)."""
    flat = flatten(tree)
    own = dict(model.named_parameters())
    names = {n.replace(".", "/") for n in own}
    missing, extra = sorted(names - flat.keys()), sorted(flat.keys() - names)
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            arr = torch.from_numpy(np.array(flat[name.replace(".", "/")], np.float32))
            if arr.ndim > 2:
                arr = tf_to_torch(arr)
            if arr.shape != p.shape:
                raise ValueError(f"shape mismatch for {name}: {tuple(arr.shape)} vs {tuple(p.shape)}")
            p.copy_(arr)
    return model


def export_jax_params(model: ATVSNet) -> dict:
    """The flat '/'-keyed tree in the JAX package's TF layouts (inverse of load_jax_params)."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        out[name.replace(".", "/")] = (torch_to_tf(t) if t.ndim > 2 else t).numpy()
    return out


def save_params(path: str, model: ATVSNet) -> None:
    """Write `model` as the flat '/'-keyed .npz in the JAX package's layouts: the file its
    utils/ckpt.load_params and this module's load_model both read."""
    np.savez(path if path.endswith(".npz") else path + ".npz", **export_jax_params(model))


def load_model(params, cfg: PipelineConfig, device=None) -> ATVSNet:
    """ATVSNet for `cfg` with weights from an .npz path or a JAX parameter tree, in eval
    mode without gradients, on `device` (CUDA when None)."""
    tree = load_npz(params) if isinstance(params, (str, os.PathLike)) else params
    model = load_jax_params(ATVSNet(cfg), tree)
    return model.to(resolve_device(device)).eval().requires_grad_(False)
