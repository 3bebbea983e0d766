"""Train-state checkpoints and TF-1 reference-checkpoint names (atvsnet_tpu/utils/ckpt.py).

Params-only files are params.save_params / params.load_model (the JAX package's flat
'/'-keyed .npz). Here:

  save_train_state / load_train_state
      the port's own full train state: one .npz with named keys, params/<path>,
      mu/<path> and nu/<path> in the JAX package's flat layout (TF kernel layouts, paths
      as in its parameter tree), `count` (the optimizer's steps) and `step`.
  load_jax_train_state
      a file that atvsnet_tpu.utils.ckpt.save_train_state wrote: leaf_<i> in
      jax.tree_util flatten order plus the treedef's string. The order of the leaves is
      read from that string, not assumed: TrainState(params, opt_state, step) with the
      optax chain's states, ScaleByAdamState(count, mu, nu) and, with a schedule,
      ScaleByScheduleState(count).
  tf_name_map / load_tf_npz
      the TF variable names of the reference checkpoint for each parameter path, and a
      loader of an .npz dumped from it under those names (numpy only).

Orbax checkpoints (the JAX package's save_params_orbax / load_params_orbax) are a JAX
library's format and have no counterpart here.
"""

from __future__ import annotations

import ast
from typing import Dict, Mapping

import numpy as np
import torch

from atvsnet_torch.models.train import AdamState, TrainState
from atvsnet_torch.nn.layers import tf_to_torch, torch_to_tf
from atvsnet_torch.params import flatten


def _path(name: str) -> str:
    return name.replace(".", "/")


def _to_tf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (torch_to_tf(t) if t.ndim > 2 else t).numpy()


def _from_tf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, np.float32))
    if t.ndim > 2:
        t = tf_to_torch(t)
    if t.shape != like.shape:
        raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(like.shape)}")
    return t.to(like.device)


def save_train_state(path: str, state: TrainState) -> None:
    """Write the full train state (params, Adam moments, count, step) for resume."""
    arrays = {"count": np.int64(state.opt_state.count), "step": np.int64(state.step)}
    for name, p in state.model.named_parameters():
        arrays[f"params/{_path(name)}"] = _to_tf(p)
        arrays[f"mu/{_path(name)}"] = _to_tf(state.opt_state.mu[name])
        arrays[f"nu/{_path(name)}"] = _to_tf(state.opt_state.nu[name])
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def _restore(state: TrainState, params: Mapping, mu: Mapping, nu: Mapping, count: int,
             step: int) -> TrainState:
    own = dict(state.model.named_parameters())
    for what, tree in (("params", params), ("mu", mu), ("nu", nu)):
        missing = sorted(set(map(_path, own)) - set(tree))
        extra = sorted(set(tree) - set(map(_path, own)))
        if missing or extra:
            raise KeyError(f"{what} of the checkpoint differ from the model: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(_from_tf(params[_path(name)], p))
    state.opt_state = AdamState(
        int(count),
        {n: _from_tf(mu[_path(n)], p) for n, p in own.items()},
        {n: _from_tf(nu[_path(n)], p) for n, p in own.items()})
    state.step = int(step)
    return state


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Restore a file of save_train_state into `state` (its model's parameters in place)."""
    with np.load(path) as z:
        groups: Dict[str, dict] = {"params": {}, "mu": {}, "nu": {}}
        for k in z.files:
            head, _, rest = k.partition("/")
            if head in groups:
                groups[head][rest] = z[k]
        return _restore(state, groups["params"], groups["mu"], groups["nu"], int(z["count"]),
                        int(z["step"]))


def _dict_after(text: str, marker: str, start: int = 0):
    """The '{...}' literal that follows `marker` in a treedef string, as a nested dict
    whose leaves are None (keys in flatten order), and the index just past it."""
    i = text.index(marker, start) + len(marker)
    i = text.index("{", i)
    depth, j = 0, i
    while True:
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        j += 1
        if depth == 0:
            break
    return ast.literal_eval(text[i:j].replace("*", "None")), j


def _leaf_paths(tree: Mapping, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.extend(_leaf_paths(v, path) if isinstance(v, Mapping) else [path])
    return out


def load_jax_train_state(path: str, state: TrainState) -> TrainState:
    """Restore a TrainState file written by the JAX package's save_train_state
    (make_optimizer's chain: clipping, optional weight decay, Adam, constant rate or a
    schedule) into `state`. The chain's Adam count and, if present, its schedule count
    must agree."""
    with np.load(path) as z:
        treedef = z["__treedef__"].tobytes().decode()
        leaves = [z[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in z.files))]
    if "namedtuple[TrainState]" not in treedef or "namedtuple[ScaleByAdamState]" not in treedef:
        raise ValueError("not a TrainState of the JAX package with an Adam optimizer")
    params_tree, end = _dict_after(treedef, "namedtuple[TrainState], [")
    mu_tree, end = _dict_after(treedef, "namedtuple[ScaleByAdamState], [*, ", end)
    nu_tree, _ = _dict_after(treedef, ",", end)
    order = _leaf_paths(params_tree)
    if _leaf_paths(mu_tree) != order or _leaf_paths(nu_tree) != order:
        raise ValueError("the Adam moments do not have the params' structure")
    P = len(order)
    scheduled = "namedtuple[ScaleByScheduleState]" in treedef
    if len(leaves) != 3 * P + 2 + scheduled:
        raise ValueError(f"{len(leaves)} leaves, expected {3 * P + 2 + scheduled} for {P} params")
    count = int(leaves[P])
    if scheduled and int(leaves[3 * P + 1]) != count:
        raise ValueError("the Adam and schedule counts of the checkpoint differ")
    return _restore(state, dict(zip(order, leaves[:P])),
                    dict(zip(order, leaves[P + 1:2 * P + 1])),
                    dict(zip(order, leaves[2 * P + 1:3 * P + 1])), count, int(leaves[-1]))


# ---------------------------------------------------------------------------------------
# TF-1 reference checkpoint names
# ---------------------------------------------------------------------------------------

_PLAIN_CONV_SCOPES = {
    "fusion1",
    "global_refine_shallow_feature",
    "conv_b2_6_2",
    "attention_prob_vol",
    "attention_prob_vol_refine",
    "global_refined_cost_vol",
}
# U-Net decoder scopes are deconv_bn: conv_b*_{4,5,6}_0 and global_refine_3dconv{4,5,6}_0
_DECONV_MARKERS = ("4_0", "5_0", "6_0")


def _tf_conv_name(scope: str, nd: int, bn: bool, transpose: bool = False) -> str:
    if not bn:
        return f"{scope}/kernel"
    op = f"conv{nd}d_transpose" if transpose else f"conv{nd}d"
    return f"{scope}/{op}/kernel"


def tf_name_map(params: Mapping) -> Dict[str, str]:
    """TF-checkpoint variable name -> flat parameter path, for a parameter tree (nested
    or flat '/'-keyed, in the JAX package's layouts, e.g. params.export_jax_params).

    Conv kernels inside a module that normalizes map to <scope>/conv{2,3}d/kernel; plain
    convs (fusion1, the output convs, conv_b2_6_2, global_refine*cost_vol, the shallow
    feature) to <scope>/kernel; deconvs to <scope>/conv{2,3}d_transpose/kernel; slim
    bottleneck convs to weights / biases; preact betas and the attention banks by name.
    """
    mapping: Dict[str, str] = {}
    for path, arr in flatten(params).items():
        parts = path.split("/")
        leaf = parts[-1]
        scope = parts[-2] if len(parts) >= 2 else ""
        if leaf == "beta":  # preact BN beta: <block>/preact/beta
            mapping[f"{parts[-3]}/preact/beta"] = path
        elif leaf in ("weight_unique", "weight_shared"):
            agg = "attention_aggregate" if "aam1" in parts[0] else "attention_aggregate_refine"
            mapping[f"{agg}/attention_activation/{leaf}"] = path
        elif leaf == "b":
            mapping[f"{'/'.join(parts[1:-1])}/biases"] = path
        elif leaf == "w":
            nd = np.ndim(arr) - 2
            rel = "/".join(parts[1:-1])
            if scope in ("shortcut", "conv1", "conv2", "conv3"):
                mapping[f"{rel}/weights"] = path
            elif scope in _PLAIN_CONV_SCOPES:
                mapping[f"{rel}/kernel"] = path
            elif any(scope.endswith(m) for m in _DECONV_MARKERS):
                mapping[_tf_conv_name(rel, nd, bn=True, transpose=True)] = path
            else:
                mapping[_tf_conv_name(rel, nd, bn=True)] = path
    return mapping


def load_tf_npz(params: Mapping, npz_path: str, strict: bool = True) -> dict:
    """Fill a parameter tree from an .npz of {tf_var_name: array} dumped from the TF
    checkpoint; returns the flat '/'-keyed tree (params.load_model takes it)."""
    mapping = tf_name_map(params)
    flat = flatten(params)
    with np.load(npz_path) as z:
        available = set(z.files)
        for tf_name, path in mapping.items():
            if tf_name in available:
                arr = z[tf_name]
                if arr.shape != flat[path].shape:
                    raise ValueError(f"shape mismatch {tf_name}: {arr.shape} vs {flat[path].shape}")
                flat[path] = arr
            elif strict:
                raise KeyError(f"missing TF variable: {tf_name}")
    return flat
