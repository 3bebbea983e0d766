"""The SPMD pipeline (atvsnet_tpu/parallel/pipeline.py): the N-view forward with its batch
split over a mesh's 'data' ranks and its view pairs over the 'view' ranks.

The same math as models.atvsnet.multi_view_forward, arranged as the JAX package's SPMD
forward arranges it:
  * stage 1 leaves out each pair's reference-direction depth, which no output reads
    (XLA drops it there): one soft-argmin per pair, not two;
  * stages 1 and 3 run pair by pair whatever cfg.pair_batch says;
  * cfg.remat wraps each pair's stage 1 and each pair's refinement in
    torch.utils.checkpoint (jax.checkpoint there).

Under a mesh each rank runs its rows of the batch and its block of pairs: the feature
towers for the reference and its own views only (batch_stat_norm is per sample, so a
view's features do not depend on the others), stages 1 and 3 for its pairs, AAM1 and
AAM2 over the view group's all-reduces, and the rest of stages 2 and 4 on every view
rank alike. The pair-stacked outputs are gathered over the view group, so every rank
returns all P pairs of its rows.

With a 'depth' axis (parallel.depth) every rank of a depth group runs the same rows and
pairs on its block of the D planes: the feature towers replicated (the JAX package
constrains features to P('data') only), every volume op on its planes with the seams
exchanged, the soft-argmins merged over the group. depth_agg_initial, depth_views, depth
(and the confidences) come out the same on every depth rank, and refined_prob_volumes is
gathered to the whole D, as the pairs are over the view group.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.geometry.depth_regression import final_depths, prob2depth
from atvsnet_torch.models.tvsnet import (
    ATVSNet,
    aam_aggregate_stacked,
    aam_output_conv,
    extract_features,
    prepare_inputs,
    tvsnet_base,
    tvsnet_refine,
)
from atvsnet_torch.nn.layers import ActQuant
from atvsnet_torch.parallel.depth import DepthSplit
from atvsnet_torch.parallel.mesh import Mesh, gather_blocks

PAIR_KEYS = ("depth_views", "refined_prob_volumes")   # (P, B, ...); every other output is (B, ...)


def multi_view_forward_spmd(model: ATVSNet, images, cams, cfg: PipelineConfig,
                            mesh: Optional[Mesh] = None, out_prob_map: bool = False,
                            upsample: bool = True) -> dict:
    """images (B, N, H, W, 3), cams (B, N, 2, 4, 4) of the whole batch -> depth_agg_initial,
    depth_views (P, B, h, w, 1), refined_prob_volumes (P, B, D, h, w) and depth (+ confidence
    with out_prob_map, + depth_up and confidence_up with upsample), with autograd recording
    as the caller has it. Every rank of a mesh calls it with the same batch and gets back
    its own rows (mesh.data_rows) with all P pairs; B must split evenly over 'data', P
    over 'view' and max_d into 8-plane-divisible blocks over 'depth'."""
    if mesh is not None:
        images, cams = mesh.data_rows(images), mesh.data_rows(cams)
    return forward_rows(model, images, cams, cfg, mesh, out_prob_map, upsample)


def forward_rows(model: ATVSNet, images, cams, cfg: PipelineConfig, mesh: Optional[Mesh] = None,
                 out_prob_map: bool = False, upsample: bool = True) -> dict:
    """multi_view_forward_spmd on this rank's rows of the batch, already taken."""
    images, cams = prepare_inputs(model, images, cams, cfg)
    N = images.shape[1]
    if N != cfg.view_num or N <= 2:
        raise ValueError(f"multi_view_forward_spmd needs view_num > 2 views, got {N} "
                         f"(cfg.view_num={cfg.view_num})")
    P, D = N - 1, cfg.max_d
    pairs = range(P) if mesh is None else mesh.pair_block(P)
    group = None if mesh is None else mesh.view_group
    split = DepthSplit.of(mesh, D)
    depth_start = cams[:, 0, 1, 3, 0]
    depth_interval = cams[:, 0, 1, 3, 1]
    cfg_pair = cfg.replace(pair_batch=False)

    # the reference and this rank's views: own[i + 1] is pair pairs[i]'s view
    own = [0] + [p + 1 for p in pairs]
    if len(own) < N:
        images = images[:, own]
    features = extract_features(model, images, cfg)
    shallow = extract_features(model, images, cfg, shallow=True)
    ref_feature, ref_cam, shallow_ref = features[:, 0], cams[:, 0], shallow[:, 0]

    def remat(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if cfg.remat else fn(*args)

    # ---- stage 1: per pair, the swapped depth only ----
    def base_pair(view_feature, view_cam):
        out = tvsnet_base(model, ref_feature, view_feature, ref_cam, view_cam, cfg_pair,
                          depth_start, depth_interval, ref_depth=False, split=split)
        return out.filtered_cost, out.depth_view

    outs = [remat(base_pair, features[:, i + 1], cams[:, p + 1]) for i, p in enumerate(pairs)]
    filtered_costs = torch.stack([c for c, _ in outs])   # (this rank's P, B, D, h, w, C)
    depth_views = torch.stack([d for _, d in outs])      # (this rank's P, B, h, w, 1)
    del outs

    # ---- stage 2: AAM1, over the view group ----
    quant, prec = ActQuant.of(cfg), cfg.fp32_precision
    cost_agg = aam_aggregate_stacked(model, filtered_costs, stage=1, group=group, split=split,
                                     quant=quant, precision=prec)
    del filtered_costs
    prob_agg = aam_output_conv(model, cost_agg, stage=1, split=split, quant=quant,
                               precision=prec)
    depth_agg = prob2depth(prob_agg, D, depth_start, depth_interval, impl=cfg.softargmin_impl,
                           split=split)

    # ---- stage 3: per-pair refinement ----
    # reference_compat: the reference's per-pair visual hull always reads camera 1
    hull_cam = cams[:, 1] if cfg.reference_compat else None

    def refine_pair(depth_view, view_cam, shallow_view):
        return tvsnet_refine(model, depth_agg, depth_view, prob_agg, cost_agg, ref_cam,
                             view_cam, shallow_ref, shallow_view, cfg, depth_start,
                             depth_interval, hull_view_cam=hull_cam, split=split)

    refined = [remat(refine_pair, depth_views[i], cams[:, p + 1], shallow[:, i + 1])
               for i, p in enumerate(pairs)]
    refined_probs = torch.stack([p for p, _ in refined])
    refined_costs = torch.stack([c for _, c in refined])
    del refined

    # ---- stage 4: AAM2, over the view group, + soft-argmin ----
    cost_agg2 = aam_aggregate_stacked(model, refined_costs, stage=2, group=group, split=split,
                                      quant=quant, precision=prec)
    del refined_costs
    final = final_depths(aam_output_conv(model, cost_agg2, stage=2, split=split, quant=quant,
                                         precision=prec),
                         cfg, depth_start, depth_interval, out_prob_map, upsample, split)
    depth_group = None if split is None else split.group
    refined_probs = gather_blocks(refined_probs, depth_group, dim=2)   # (P, B, D, h, w)
    return {"depth_agg_initial": depth_agg, "depth_views": gather_blocks(depth_views, group),
            "refined_prob_volumes": gather_blocks(refined_probs, group), **final}


def sharded_forward(mesh: Mesh, cfg: PipelineConfig):
    """The forward over `mesh` as one call (jit_sharded_forward of the JAX package): every
    rank calls fn(model, images, cams) with the same whole batch and gets the whole
    batch's outputs back. The weights are the model's, the same on every rank."""

    @torch.no_grad()
    def fn(model: ATVSNet, images, cams, out_prob_map: bool = False, upsample: bool = True):
        out = multi_view_forward_spmd(model, images, cams, cfg, mesh, out_prob_map, upsample)
        # every data rank's rows, in batch order (the pair-stacked outputs are (P, B, ...))
        return {k: gather_blocks(v, mesh.data_group, dim=1 if k in PAIR_KEYS else 0)
                for k, v in out.items()}

    return fn
