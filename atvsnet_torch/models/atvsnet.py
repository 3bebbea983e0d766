"""A-TVSNet: the full N-view pipeline (atvsnet_tpu/models/atvsnet.py).

  Stage 1  per-pair base nets     (CRM weights shared, both sweep directions)
  Stage 2  AAM1 aggregation       attention over the stacked pair volumes
  Stage 3  per-pair refinement    consuming the aggregated volumes
  Stage 4  AAM2 + soft-argmin     native and 4x-upsampled depth (+ confidence)

The JAX package's lax.scan over pairs is a Python loop here; all volumes stay on the
device. With cfg.pair_batch the two sweep directions of a pair (stage 1) and all N-1
refinements (stage 3) each run as one batch instead: the same math, fewer and larger
convolutions, more memory.
"""

from __future__ import annotations

import torch

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
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd
from atvsnet_torch.utils.profiling import TRACER


@torch.no_grad()
def multi_view_forward(model: ATVSNet, images, cams, cfg: PipelineConfig,
                       out_prob_map: bool = False, upsample: bool = True) -> dict:
    """images (B, N, H, W, 3), cams (B, N, 2, 4, 4) -> depth/confidence outputs.

    Runs on the model's device. upsample=False skips the 4x-upsampled outputs
    (no depth_up / confidence_up keys).

    While a profiler records, utils.profiling.TRACER records the call as the span
    `forward`, with its stages forward.fem, .pairs, .aam1, .refine and .aam2 in order,
    each with its device time (adjacent stages share their boundary events).
    """
    device = next(model.parameters()).device
    with TRACER.span("forward", device=device):
        images, cams = prepare_inputs(model, images, cams, cfg)
        N = images.shape[1]
        if N != cfg.view_num or N <= 2:
            raise ValueError(f"multi_view_forward needs view_num > 2 views, got {N} "
                             f"(cfg.view_num={cfg.view_num})")
        D = cfg.max_d
        depth_start = cams[:, 0, 1, 3, 0]
        depth_interval = cams[:, 0, 1, 3, 1]
        impl = cfg.softargmin_impl

        with TRACER.span("forward.fem", device=device):
            features = extract_features(model, images, cfg)                # (B, N, h, w, F)
            shallow = extract_features(model, images, cfg, shallow=True)   # (B, N, h, w, 16)
            ref_feature, ref_cam, shallow_ref = features[:, 0], cams[:, 0], shallow[:, 0]

        # ---- stage 1: per-pair base nets ----
        with TRACER.span("forward.pairs", device=device):
            filtered_costs, prob_volumes, depth_views = [], [], []
            for view_i in range(1, N):
                out = tvsnet_base(model, ref_feature, features[:, view_i], ref_cam,
                                  cams[:, view_i], cfg, depth_start, depth_interval)
                filtered_costs.append(out.filtered_cost)
                prob_volumes.append(out.prob_volume)
                depth_views.append(out.depth_view)
            filtered_costs = torch.stack(filtered_costs)   # (P, B, D, h, w, C)
            depth_views = torch.stack(depth_views)         # (P, B, h, w, 1)

        # ---- stage 2: AAM1 ----
        with TRACER.span("forward.aam1", device=device):
            quant, prec = ActQuant.of(cfg), cfg.fp32_precision
            cost_agg = aam_aggregate_stacked(model, filtered_costs, stage=1, quant=quant,
                                             precision=prec)                       # (B,D,h,w,C)
            del filtered_costs
            prob_agg = aam_output_conv(model, cost_agg, stage=1, quant=quant,
                                       precision=prec)                             # (B,D,h,w)
            conf_agg = None
            if out_prob_map:
                depth_agg, conf_agg = prob2depth(prob_agg, D, depth_start, depth_interval, True,
                                                 impl=impl)
            else:
                depth_agg = prob2depth(prob_agg, D, depth_start, depth_interval, impl=impl)

        # ---- stage 3: per-pair refinement ----
        with TRACER.span("forward.refine", device=device):
            # reference_compat: the reference's per-pair visual hull always reads camera 1
            hull_cam = cams[:, 1] if cfg.reference_compat else None
            if cfg.pair_batch:
                cost_res, prob_res = refine_pairs_batched(model, depth_agg, depth_views, prob_agg,
                                                          cams, shallow, cfg, depth_start,
                                                          depth_interval, hull_cam)
                refined_probs = prob_agg[None] + prob_res.to(prob_agg.dtype)
                refined_costs = cost_agg[None] + cost_res.to(cost_agg.dtype)
            else:
                refined_probs, refined_costs = [], []
                for view_i in range(1, N):
                    rp, rc = tvsnet_refine(model, depth_agg, depth_views[view_i - 1], prob_agg,
                                           cost_agg, ref_cam, cams[:, view_i], shallow_ref,
                                           shallow[:, view_i], cfg, depth_start, depth_interval,
                                           hull_view_cam=hull_cam)
                    refined_probs.append(rp)
                    refined_costs.append(rc)
                refined_probs = torch.stack(refined_probs)
                refined_costs = torch.stack(refined_costs)

        # ---- stage 4: AAM2 + (upsampled) soft-argmin ----
        with TRACER.span("forward.aam2", device=device):
            cost_agg2 = aam_aggregate_stacked(model, refined_costs, stage=2, quant=quant,
                                              precision=prec)
            del refined_costs
            final = final_depths(aam_output_conv(model, cost_agg2, stage=2, quant=quant,
                                                 precision=prec),
                                 cfg, depth_start, depth_interval, out_prob_map, upsample)

        out = {
            "depth_agg_initial": depth_agg,
            "prob_volume_agg": prob_agg,
            "prob_volumes": torch.stack(prob_volumes),        # (P, B, D, h, w)
            "refined_prob_volumes": refined_probs,
            "depth_views": depth_views,
            **final,
        }
        if out_prob_map:
            out["confidence_agg_initial"] = conf_agg
        return out


def multi_view_forward_train(model: ATVSNet, images, cams, cfg: PipelineConfig,
                             out_prob_map: bool = False, upsample: bool = False) -> dict:
    """The forward that training differentiates, on one process:
    parallel.pipeline.multi_view_forward_spmd without a mesh (see there)."""
    return multi_view_forward_spmd(model, images, cams, cfg, out_prob_map=out_prob_map,
                                   upsample=upsample)


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
