"""A-TVSNet: the full N-view pipeline (atvsnet_tpu/models/atvsnet.py).

  Stage 1  per-pair base nets     (CRM weights shared, both sweep directions)
  Stage 2  AAM1 aggregation       attention over the stacked pair volumes
  Stage 3  per-pair refinement    consuming the aggregated volumes
  Stage 4  AAM2 + soft-argmin     native and 4x-upsampled depth (+ confidence)

`forward_stages` writes the stages once; the entry points differ only in its arguments:
`multi_view_forward` (serving and eval, under no_grad, every output),
`multi_view_forward_train` (the forward that training differentiates) and, over a mesh,
parallel.pipeline's forward_rows and models.train's loss, which pass this rank's pairs,
the view group and the depth split.

The JAX package's lax.scan over pairs is a Python loop here; all volumes stay on the
device. With cfg.pair_batch the two sweep directions of a pair (stage 1) and all N-1
refinements (stage 3) each run as one batch instead: the same math, fewer and larger
convolutions, more memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.geometry.depth_regression import final_depths, prob2depth
from atvsnet_torch.models.tvsnet import (
    ATVSNet,
    aam_aggregate_stacked,
    aam_output_conv,
    extract_features,
    prepare_inputs,
    refinement,
    tvsnet_base,
    tvsnet_refine,
)
from atvsnet_torch.nn.layers import ActQuant
from atvsnet_torch.parallel.mesh import gather_blocks
from atvsnet_torch.utils.profiling import TRACER


def forward_stages(model: ATVSNet, images, cams, cfg: PipelineConfig,
                   pairs: Optional[Sequence[int]] = None,
                   group: Optional[dist.ProcessGroup] = None, split=None,
                   ref_depth: bool = True, out_prob_map: bool = False,
                   upsample: bool = True) -> dict:
    """images (B, N, H, W, 3), cams (B, N, 2, 4, 4) -> depth_agg_initial, refined_prob_volumes
    (P, B, D, h, w), depth_views (P, B, h, w, 1) and depth (+ confidence with out_prob_map,
    + depth_up and confidence_up with upsample), on the model's device, with autograd
    recording as the caller has it.

    pairs: the pairs this rank runs (pair p is view p + 1; all P = N - 1 by default): the
    feature towers run for the reference and their views only (batch_stat_norm is per
    sample, so a view's features do not depend on the others), stages 1 and 3 for them.
    group: the 'view' group whose ranks hold the other pairs: AAM1 and AAM2 reduce over it,
    and depth_views and refined_prob_volumes are gathered over it, so every rank returns
    all P pairs. split (parallel.depth.DepthSplit): every volume holds this rank's block of
    the D planes, the soft-argmins merge over its group, and refined_prob_volumes is
    gathered to the whole D.

    ref_depth: stage 1 also regresses each pair's reference-direction depth, which no
    output reads, and the served outputs come back too: prob_volumes (P, B, D, h, w),
    prob_volume_agg (B, D, h, w) and, with out_prob_map, confidence_agg_initial. False
    leaves them out, as the JAX package's SPMD forward does (one soft-argmin a pair in
    stage 1, which XLA drops there).
    cfg.pair_batch is honoured where ref_depth holds, with no split and every pair here;
    cfg.remat wraps each pair's stage 1 and refinement in torch.utils.checkpoint while
    autograd records (jax.checkpoint in the JAX package).

    While a profiler records, utils.profiling.TRACER records the call as the span
    `forward`, with its stages forward.fem, .pairs, .aam1, .refine and .aam2 in order,
    each with its device time (adjacent stages share their boundary events).
    """
    device = next(model.parameters()).device
    with TRACER.span("forward", device=device):
        images, cams = prepare_inputs(model, images, cams, cfg)
        N = images.shape[1]
        if N != cfg.view_num or N <= 2:
            raise ValueError(f"the N-view forward needs view_num > 2 views, got {N} "
                             f"(cfg.view_num={cfg.view_num})")
        D = cfg.max_d
        pairs = range(N - 1) if pairs is None else pairs
        own = [0] + [p + 1 for p in pairs]     # own[i + 1] is pair pairs[i]'s view
        batch_pairs = cfg.pair_batch and ref_depth and split is None and len(own) == N
        cfg_base = cfg.replace(pair_batch=batch_pairs)
        depth_start = cams[:, 0, 1, 3, 0]
        depth_interval = cams[:, 0, 1, 3, 1]
        remat = cfg.remat and torch.is_grad_enabled()

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        with TRACER.span("forward.fem", device=device):
            if len(own) < N:
                images = images[:, own]
            features = extract_features(model, images, cfg)                # (B, n, h, w, F)
            shallow = extract_features(model, images, cfg, shallow=True)   # (B, n, h, w, 16)
            ref_feature, ref_cam, shallow_ref = features[:, 0], cams[:, 0], shallow[:, 0]

        # ---- stage 1: per-pair base nets ----
        with TRACER.span("forward.pairs", device=device):
            def base_pair(view_feature, view_cam):
                out = tvsnet_base(model, ref_feature, view_feature, ref_cam, view_cam, cfg_base,
                                  depth_start, depth_interval, ref_depth=ref_depth, split=split)
                kept = (out.filtered_cost, out.depth_view)
                return kept + (out.prob_volume,) if ref_depth else kept

            outs = [run(base_pair, features[:, i + 1], cams[:, p + 1])
                    for i, p in enumerate(pairs)]
            filtered_costs = torch.stack([o[0] for o in outs])   # (P, B, D, h, w, C)
            depth_views = torch.stack([o[1] for o in outs])      # (P, B, h, w, 1)
            prob_volumes = [o[2] for o in outs] if ref_depth else None
            del outs

        # ---- stage 2: AAM1 ----
        with TRACER.span("forward.aam1", device=device):
            quant, prec = ActQuant.of(cfg), cfg.fp32_precision
            cost_agg = aam_aggregate_stacked(model, filtered_costs, stage=1, group=group,
                                             split=split, quant=quant, precision=prec)
            del filtered_costs
            prob_agg = aam_output_conv(model, cost_agg, stage=1, split=split, quant=quant,
                                       precision=prec)                     # (B, D, h, w)
            conf_agg = None
            if ref_depth and out_prob_map:
                depth_agg, conf_agg = prob2depth(prob_agg, D, depth_start, depth_interval, True,
                                                 impl=cfg.softargmin_impl, split=split)
            else:
                depth_agg = prob2depth(prob_agg, D, depth_start, depth_interval,
                                       impl=cfg.softargmin_impl, split=split)

        # ---- stage 3: per-pair refinement ----
        with TRACER.span("forward.refine", device=device):
            # reference_compat: the reference's per-pair visual hull always reads camera 1
            hull_cam = cams[:, 1] if cfg.reference_compat else None
            if batch_pairs:
                cost_res, prob_res = refine_pairs_batched(model, depth_agg, depth_views, prob_agg,
                                                          cams, shallow, cfg, depth_start,
                                                          depth_interval, hull_cam)
                refined_probs = prob_agg[None] + prob_res.to(prob_agg.dtype)
                refined_costs = cost_agg[None] + cost_res.to(cost_agg.dtype)
            else:
                def refine_pair(depth_view, view_cam, shallow_view):
                    return tvsnet_refine(model, depth_agg, depth_view, prob_agg, cost_agg,
                                         ref_cam, view_cam, shallow_ref, shallow_view, cfg,
                                         depth_start, depth_interval, hull_view_cam=hull_cam,
                                         split=split)

                refined = [run(refine_pair, depth_views[i], cams[:, p + 1], shallow[:, i + 1])
                           for i, p in enumerate(pairs)]
                refined_probs = torch.stack([r[0] for r in refined])
                refined_costs = torch.stack([r[1] for r in refined])
                del refined

        # ---- stage 4: AAM2 + (upsampled) soft-argmin ----
        with TRACER.span("forward.aam2", device=device):
            cost_agg2 = aam_aggregate_stacked(model, refined_costs, stage=2, group=group,
                                              split=split, quant=quant, precision=prec)
            del refined_costs
            final = final_depths(aam_output_conv(model, cost_agg2, stage=2, split=split,
                                                 quant=quant, precision=prec),
                                 cfg, depth_start, depth_interval, out_prob_map, upsample, split)

        # every rank returns all P pairs of its rows, over the whole D
        refined_probs = gather_blocks(refined_probs, None if split is None else split.group,
                                      dim=2)
        depth_views = gather_blocks(depth_views, group)
        refined_probs = gather_blocks(refined_probs, group)
        out = {"depth_agg_initial": depth_agg}
        if ref_depth:
            out |= {"prob_volume_agg": prob_agg, "prob_volumes": torch.stack(prob_volumes)}
        out |= {"refined_prob_volumes": refined_probs, "depth_views": depth_views, **final}
        if conf_agg is not None:
            out["confidence_agg_initial"] = conf_agg
        return out


@torch.no_grad()
def multi_view_forward(model: ATVSNet, images, cams, cfg: PipelineConfig,
                       out_prob_map: bool = False, upsample: bool = True) -> dict:
    """images (B, N, H, W, 3), cams (B, N, 2, 4, 4) -> depth/confidence outputs: the served
    forward, forward_stages with every output and cfg.pair_batch honoured.

    Runs on the model's device. upsample=False skips the 4x-upsampled outputs
    (no depth_up / confidence_up keys).
    """
    return forward_stages(model, images, cams, cfg, out_prob_map=out_prob_map,
                          upsample=upsample)


def multi_view_forward_train(model: ATVSNet, images, cams, cfg: PipelineConfig,
                             out_prob_map: bool = False, upsample: bool = False) -> dict:
    """The forward that training differentiates, on one process: forward_stages without
    the reference-direction depths and the served outputs (ref_depth=False)."""
    return forward_stages(model, images, cams, cfg, ref_depth=False,
                          out_prob_map=out_prob_map, upsample=upsample)


def refine_pairs_batched(model: ATVSNet, depth_agg, depth_views, prob_agg, cams, shallow,
                         cfg: PipelineConfig, depth_start, depth_interval, hull_cam=None):
    """Stage 3 for all P = N - 1 pairs as one batch of P * B through one set of refine-net
    convs; the shared aggregated volumes tile over the pairs.

    depth_agg (B, h, w, 1), depth_views (P, B, h, w, 1), prob_agg (B, D, h, w),
    cams (B, N, 2, 4, 4), shallow (B, N, h, w, F). Returns the residuals pair-leading:
    cost (P, B, D, h, w, C) and prob (P, B, D, h, w).

    Exact without any group argument: batch_stat_norm's statistics are per sample, so
    every stacked pair is normalized by itself, as in the per-pair loop.
    """
    B, N = cams.shape[:2]
    P = N - 1

    def tile_pairs(x):
        """(B, ...) -> (P * B, ...): P copies stacked on the batch axis."""
        return x.repeat((P,) + (1,) * (x.ndim - 1))

    def fold_pairs(x):
        """(B, P, ...) -> (P * B, ...), pair-major like the stacked stage-1 outputs."""
        return x.transpose(0, 1).reshape((P * B,) + x.shape[2:])

    cost_res, prob_res = refinement(
        model, tile_pairs(depth_agg), depth_views.reshape((P * B,) + depth_views.shape[2:]),
        tile_pairs(cams[:, 0]), fold_pairs(cams[:, 1:]), tile_pairs(shallow[:, 0]),
        fold_pairs(shallow[:, 1:]), tile_pairs(prob_agg), cfg, depth_start.repeat(P),
        depth_interval.repeat(P),
        hull_view_cam=None if hull_cam is None else tile_pairs(hull_cam))
    return (cost_res.reshape((P, B) + cost_res.shape[1:]),
            prob_res.reshape((P, B) + prob_res.shape[1:]))


def center_images(images: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel variance normalization (population std, eps 1e-8) of
    (..., H, W, C) images of any dtype."""
    x = images.to(torch.float32)
    mean = x.mean(dim=(-3, -2), keepdim=True)
    var = (x.square().mean(dim=(-3, -2), keepdim=True) - mean.square()).clamp(min=0.0)
    return (x - mean) / (torch.sqrt(var) + 1e-8)


def sweep_to_depth(depth_sweep: torch.Tensor, inverse_depth: bool = True,
                   eps: float = 1e-10) -> torch.Tensor:
    """Sweep-space soft-argmin output to metric depth: non-positive inverse depths
    become 0; identity when the sweep is already metric."""
    if not inverse_depth:
        return depth_sweep
    return torch.where(depth_sweep < eps, 0.0, 1.0 / depth_sweep.clamp(min=eps))
