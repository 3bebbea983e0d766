"""TVSNet: two-view plane-sweep stereo with geometry-aware refinement (atvsnet_tpu/models/tvsnet.py).

`ATVSNet` holds every parameter of the pipeline; its submodule and parameter names
mirror the JAX tree (fem/conv0_0/w is fem.conv0_0.w). The functions here take it in
the place of the JAX package's params dict.

The config's numerics reach the leaves from here: act_quant as an nn.layers.ActQuant,
warp_quant as plane_sweep_warp's quant, fp32_precision as every conv's `precision`; the
AAM functions take the ActQuant and the precision from their caller. A depth `split`
(parallel.depth.DepthSplit) makes every volume this rank's block of planes: the sweeps
warp those planes only, at their global sweep values, while everything plane-indexed
(homographies, sweep values, the geometric denominator depth_interval * D, the visual
hull) reads the global D.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as tnn

from atvsnet_torch import resolve_device
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.geometry.depth_regression import prob2depth, prob2depth_upsample
from atvsnet_torch.geometry.homography import get_homographies, sweep_depths
from atvsnet_torch.geometry.warp import (
    plane_sweep_warp,
    plane_sweep_warp_with_nearest,
    transform_depth,
    warp_by_depth,
)
from atvsnet_torch.nn.aam import (Attention, OutputConv, attention_aggregate,
                                  attention_aggregate_stacked, output_conv)
from atvsnet_torch.nn.crm import CRM
from atvsnet_torch.nn.fem import FEM, FEMShallow
from atvsnet_torch.nn.layers import ActQuant
from atvsnet_torch.nn.refine import RefineNet


class ATVSNet(tnn.Module):
    """Full A-TVSNet parameter set (names mirror the reference variable scopes)."""

    def __init__(self, cfg: PipelineConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = cfg.fem_base_filter, generator
        shallow_f = cfg.shallow_base_filter
        crm_f = cfg.crm_base_filter
        photo_ch = 3 * shallow_f              # photo cost + photo err + ref feature
        geo_ch = (shallow_f + 1) + 1 + 1      # geo volume (1+F) + geo err + ref depth
        self.fem = FEM(f, g)
        self.fem_shallow = FEMShallow(shallow_f, g)
        self.crm = CRM(2 * f, crm_f, prob_output=True, generator=g)
        self.refine = RefineNet(photo_ch, geo_ch, cfg.refine_base_filter, g)
        self.aam1_att = Attention(crm_f, generator=g)
        self.aam1_out = OutputConv("attention_prob_vol", crm_f, g)
        self.aam2_att = Attention(crm_f, generator=g)
        self.aam2_out = OutputConv("attention_prob_vol_refine", crm_f, g)


def init_model(cfg: PipelineConfig, seed: int = 0, device=None) -> ATVSNet:
    """Randomly initialised model (truncated Glorot normal from a seeded generator).

    The draws differ from the JAX package's init_params; to hold the two against each
    other, load the JAX parameters with params.load_model instead.
    """
    g = torch.Generator().manual_seed(seed)
    return ATVSNet(cfg, g).to(resolve_device(device)).eval().requires_grad_(False)


def prepare_inputs(model: ATVSNet, images, cams, cfg: PipelineConfig):
    """Images and cams (arrays or tensors) as fp32 tensors on the model's device.

    It sets no process-wide flag: each conv and matmul leaf scopes TF32 for its own call
    (cfg.fp32_precision, ops.fp32_passes), and the geometry's matmuls keep it off.
    """
    device = next(model.parameters()).device
    return (torch.as_tensor(images, dtype=torch.float32, device=device),
            torch.as_tensor(cams, dtype=torch.float32, device=device))


def extract_features(model: ATVSNet, images: torch.Tensor, cfg: PipelineConfig,
                     shallow: bool = False) -> torch.Tensor:
    """(B, N, H, W, 3) -> (B, N, H/4, W/4, F), weights shared across views.

    The views fold into the batch axis: batch_stat_norm's statistics are per sample,
    so each view keeps its own statistics, as in the reference's one tower per image.
    """
    B, N = images.shape[:2]
    net = model.fem_shallow if shallow else model.fem
    out = net(images.reshape((B * N,) + images.shape[2:]).to(cfg.dtype), eps=cfg.bn_eps,
              precision=cfg.fp32_precision)
    return out.reshape((B, N) + out.shape[1:])


def build_cost_volume(ref_feature: torch.Tensor, view_feature: torch.Tensor,
                      ref_cam: torch.Tensor, view_cam: torch.Tensor, cfg: PipelineConfig,
                      depth_start: torch.Tensor, depth_interval: torch.Tensor,
                      warp_ref: bool = False):
    """The explicit cost volume concat(reference over D, view warped per plane),
    (B, D, h, w, 2F), and the view's homographies (B, D, 3, 3) (reference
    model.py:157-200). warp_ref=True warps the reference through its ref->ref
    homographies instead of tiling it. tvsnet_base never builds this volume: it feeds the
    D-constant reference half to the CRM as 2D convs."""
    D = cfg.max_d
    homographies = get_homographies(ref_cam, view_cam, D, depth_start, depth_interval,
                                    cfg.inverse_depth)
    if warp_ref:
        ref_h = get_homographies(ref_cam, ref_cam, D, depth_start, depth_interval,
                                 cfg.inverse_depth)
        ref_vol = plane_sweep_warp(ref_feature, ref_h, quant=cfg.warp_quant)
    else:
        ref_vol = ref_feature[:, None].expand(-1, D, -1, -1, -1)
    view_vol = plane_sweep_warp(view_feature, homographies, quant=cfg.warp_quant)
    return torch.cat([ref_vol, view_vol], dim=-1), homographies


class PairOutputs(NamedTuple):
    depth: Optional[torch.Tensor]       # (B, h, w, 1) soft-argmin depth of the ref->view sweep
    prob_volume: torch.Tensor           # (B, D, h, w) regularized cost
    filtered_cost: torch.Tensor         # (B, D, h, w, crm_f) filtered cost volume for AAM
    depth_view: torch.Tensor            # (B, h, w, 1) depth of the swapped (view->ref) sweep


def _planes(split) -> slice:
    """This rank's planes of a full-D axis (all of them without a split)."""
    return slice(None) if split is None else split.planes


def tvsnet_base(model: ATVSNet, ref_feature, view_feature, ref_cam, view_cam,
                cfg: PipelineConfig, depth_start, depth_interval,
                ref_depth: bool = True, split=None) -> PairOutputs:
    """One view pair through cost volume + CRM, in both directions (siamese: the CRM
    weights are shared, reference model.py:398-417).

    The tiled-reference half of the cost volume is D-constant, so it enters the CRM
    input convs as 2D convs (the (warped, ref_feature) tuple); only the warped half is
    materialized. cfg.pair_batch runs the two directions as one batch of 2 (the
    soft-argmin then sees one (2B, D, h, w) volume in the place of two (B, D, h, w)).
    ref_depth=False leaves the reference direction's depth out (depth is None), as the
    training forward does; it needs the sequential path. split: the volumes hold this
    rank's planes (sequential path only).
    """
    D = cfg.max_d
    quant = ActQuant.of(cfg)

    if cfg.pair_batch:
        if not ref_depth or split is not None:
            raise ValueError("ref_depth=False and a depth split need pair_batch=False")
        # Both directions as two elements of one batch through one set of CRM convs.
        # Exact, with no group argument anywhere: batch_stat_norm takes its statistics
        # per sample, so each stacked sweep is normalized by itself, as it is alone.
        B = ref_feature.shape[0]
        src = torch.cat([view_feature, ref_feature], dim=0)
        dst = torch.cat([ref_feature, view_feature], dim=0)
        cam_a = torch.cat([ref_cam, view_cam], dim=0)
        cam_b = torch.cat([view_cam, ref_cam], dim=0)
        ds2, di2 = depth_start.repeat(2), depth_interval.repeat(2)
        homos = get_homographies(cam_a, cam_b, D, ds2, di2, cfg.inverse_depth)
        filtered2, prob2 = model.crm((plane_sweep_warp(src, homos, quant=cfg.warp_quant), dst),
                                     eps=cfg.bn_eps, quant=quant, precision=cfg.fp32_precision)
        depth2 = prob2depth(prob2, D, ds2, di2, impl=cfg.softargmin_impl)
        return PairOutputs(depth2[:B], prob2[:B], filtered2[:B], depth2[B:])

    def sweep(view_f, ref_c, view_c):
        h = get_homographies(ref_c, view_c, D, depth_start, depth_interval, cfg.inverse_depth)
        return plane_sweep_warp(view_f, h[:, _planes(split)], quant=cfg.warp_quant)

    def regress(prob):
        return prob2depth(prob, D, depth_start, depth_interval, impl=cfg.softargmin_impl,
                          split=split)

    warped = sweep(view_feature, ref_cam, view_cam)
    filtered_cost, prob = model.crm((warped, ref_feature), eps=cfg.bn_eps, quant=quant,
                                    split=split, precision=cfg.fp32_precision)
    depth = regress(prob) if ref_depth else None

    warped_v = sweep(ref_feature, view_cam, ref_cam)
    _, prob_view = model.crm((warped_v, view_feature), eps=cfg.bn_eps, quant=quant, split=split,
                             precision=cfg.fp32_precision)
    return PairOutputs(depth, prob, filtered_cost, regress(prob_view))


def refinement(model: ATVSNet, depth_ref, depth_view, ref_cam, view_cam, shallow_ref,
               shallow_view, prob_vol, cfg: PipelineConfig, depth_start, depth_interval,
               hull_view_cam: Optional[torch.Tensor] = None, split=None):
    """Geometry-aware refinement of one pair (reference model.py:227-339).

    depth_ref/depth_view: (B, h, w, 1) initial depths at cost-volume resolution;
    shallow_*: (B, h, w, F) low-level features; prob_vol: (B, D, h, w).
    Returns (cost_residual (B, D, h, w, crm_f), prob_residual (B, D, h, w)).

    hull_view_cam (cfg.reference_compat): the visual hull's view term uses this camera
    instead of the pair's own, reproducing the reference bug where the hull always reads
    camera 1. When None the hull uses the pair's cameras and its nearest warp comes
    from the shared plane-sweep sample.

    split: prob_vol and the returned volumes hold this rank's planes; the depths and the
    2D errors are the same on every rank.
    """
    D = cfg.max_d
    inv = cfg.inverse_depth
    F = shallow_ref.shape[-1]
    f32 = torch.float32
    planes = _planes(split)

    depth_view_trans = transform_depth(depth_view, view_cam, ref_cam, inv)
    homographies = get_homographies(ref_cam, view_cam, D, depth_start, depth_interval,
                                    inv)[:, planes]

    # photometric, geometric and visual-hull sweeps warp the same sources by the same
    # homographies: one sample serves all three
    stacked_src = torch.cat([shallow_view, depth_view_trans.to(shallow_view.dtype)], dim=-1)
    warped_all, warped_near, mask = plane_sweep_warp_with_nearest(
        stacked_src, homographies, nearest_slice=slice(F, F + 1))
    warped_feat = warped_all[..., :F]
    warped_depth = warped_all[..., F:].to(f32)
    if hull_view_cam is None:
        hull_depth = warped_near.to(f32)
    else:
        dvt_hull = transform_depth(depth_view, hull_view_cam, ref_cam, inv)
        h_hull = get_homographies(ref_cam, hull_view_cam, D, depth_start, depth_interval,
                                  inv)[:, planes]
        hull_depth = plane_sweep_warp(dvt_hull.to(f32), h_hull, method="nearest")

    # photometric L1 cost volume over shallow features (model.py:270-280)
    cost_vol_photo = (warped_feat - shallow_ref[:, None]).abs() * mask.to(shallow_ref.dtype)

    # geometric L1 depth-consistency volume (model.py:285-300); the reference's
    # F identical view channels stay one channel (the refine net collapses its kernel)
    sweep = sweep_depths(depth_start.to(f32), depth_interval.to(f32), D)[:, planes, None, None, None]
    denom = (depth_interval.to(f32) * D)[:, None, None, None, None]
    geo_ref = (depth_ref[:, None] - sweep).abs() / denom                 # (B, D, h, w, 1)
    geo_view = (warped_depth - sweep).abs() / denom * mask.to(f32)

    # per-pixel photo/geo error at the initial depth (model.py:306-316), kept 2D
    warped_f, mask_p = warp_by_depth(shallow_view, ref_cam, view_cam, depth_ref, inv,
                                     output_mask=True)
    photo_err = (warped_f - shallow_ref).abs() * mask_p.to(shallow_ref.dtype)
    warped_d, mask_g = warp_by_depth(depth_view_trans, ref_cam, view_cam, depth_ref, inv,
                                     method="nearest", output_mask=True)
    geo_err = (warped_d - depth_ref).abs() * mask_g.to(f32)

    # visual hull over the pair's initial depths (model.py:321-324)
    sweep_hw = sweep[..., 0]                                            # (B, D, 1, 1)

    def free_space(d):
        cmp = d > sweep_hw if inv else sweep_hw > d
        return ((d > 0) & cmp).to(f32)

    vis_hull = (free_space(depth_ref[..., 0][:, None].to(f32))
                + free_space(hull_depth[..., 0])) / 2.0

    dt = cfg.dtype
    photo_group = (cost_vol_photo.to(dt),
                   torch.cat([photo_err.to(dt), shallow_ref.to(dt)], dim=-1))
    geo_group = (torch.cat([geo_ref.to(dt), geo_view.to(dt)], dim=-1),
                 torch.cat([geo_err.to(dt), depth_ref.to(dt)], dim=-1), F)
    return model.refine(photo_group, geo_group, prob_vol[..., None].to(dt),
                        vis_hull[..., None].to(dt), eps=cfg.bn_eps, quant=ActQuant.of(cfg),
                        split=split, precision=cfg.fp32_precision)


def tvsnet_refine(model: ATVSNet, depth_ref, depth_view, prob_vol, filtered_cost, ref_cam,
                  view_cam, shallow_ref, shallow_view, cfg: PipelineConfig, depth_start,
                  depth_interval, hull_view_cam: Optional[torch.Tensor] = None, split=None):
    """Residual refinement of (prob, cost) volumes (reference model.py:428-441)."""
    cost_residual, prob_residual = refinement(
        model, depth_ref, depth_view, ref_cam, view_cam, shallow_ref, shallow_view,
        prob_vol, cfg, depth_start, depth_interval, hull_view_cam=hull_view_cam, split=split)
    return (prob_vol + prob_residual.to(prob_vol.dtype),
            filtered_cost + cost_residual.to(filtered_cost.dtype))


def aam_aggregate_stacked(model: ATVSNet, cost_volumes: torch.Tensor, stage: int,
                          group: Optional[dist.ProcessGroup] = None, split=None,
                          quant: Optional[ActQuant] = None,
                          precision: str = "highest") -> torch.Tensor:
    """AAM over the view-leading (P, B, D, h, w, C) stack; stage 1 = AAM1, 2 = AAM2. With a
    'view' group, the stack holds this rank's pairs and AAM runs over the group's; with a
    depth split, D holds this rank's planes. quant: ActQuant.of(cfg), whose "int8mxu" runs
    the AAM's conv on int8 operands; precision: cfg.fp32_precision."""
    return attention_aggregate_stacked(model.aam1_att if stage == 1 else model.aam2_att,
                                       cost_volumes, group, split, quant, precision)


def aam_output_conv(model: ATVSNet, agg_cost: torch.Tensor, stage: int,
                    split=None, quant: Optional[ActQuant] = None,
                    precision: str = "highest") -> torch.Tensor:
    if stage == 1:
        return output_conv(model.aam1_out, "attention_prob_vol", agg_cost, split, quant,
                           precision)
    return output_conv(model.aam2_out, "attention_prob_vol_refine", agg_cost, split, quant,
                       precision)


def aam_aggregate(model: ATVSNet, cost_volumes: torch.Tensor, stage: int,
                  quant: Optional[ActQuant] = None, precision: str = "highest") -> torch.Tensor:
    """AAM over the view-trailing (B, D, h, w, C, P) per-pair volumes -> (B, D, h, w, C);
    stage 1 = AAM1, 2 = AAM2 (reference model.py:445-468)."""
    return attention_aggregate(model.aam1_att if stage == 1 else model.aam2_att, cost_volumes,
                               quant, precision)


def cost_volume_aggregation(model: ATVSNet, cost_volumes: torch.Tensor, stage: int = 1,
                            keepchannel: bool = False, quant: Optional[ActQuant] = None,
                            precision: str = "highest") -> torch.Tensor:
    """aam_aggregate, then (unless keepchannel) the stage's 1-channel output conv:
    (B, D, h, w, C) with keepchannel, else (B, D, h, w) (reference model.py:445-468)."""
    agg = aam_aggregate(model, cost_volumes, stage, quant, precision)
    return agg if keepchannel else aam_output_conv(model, agg, stage, quant=quant,
                                                   precision=precision)


@torch.no_grad()
def two_view_forward(model: ATVSNet, images, cams, cfg: PipelineConfig) -> dict:
    """Two-view TVSNet (reference model.py:346-377): images (B, 2, H, W, 3), cams (B, 2, 2, 4, 4)."""
    images, cams = prepare_inputs(model, images, cams, cfg)
    depth_start = cams[:, 0, 1, 3, 0]
    depth_interval = cams[:, 0, 1, 3, 1]
    features = extract_features(model, images, cfg)
    base = tvsnet_base(model, features[:, 0], features[:, 1], cams[:, 0], cams[:, 1], cfg,
                       depth_start, depth_interval)
    shallow = extract_features(model, images, cfg, shallow=True)
    _, prob_residual = refinement(model, base.depth, base.depth_view, cams[:, 0], cams[:, 1],
                                  shallow[:, 0], shallow[:, 1], base.prob_volume, cfg,
                                  depth_start, depth_interval)
    refined_prob_vol = base.prob_volume + prob_residual.to(base.prob_volume.dtype)
    depth, depth_up = prob2depth_upsample(refined_prob_vol, cfg.max_d, depth_start,
                                          depth_interval, impl=cfg.softargmin_impl)
    return {"refined_prob_vol": refined_prob_vol, "depth": depth, "depth_up": depth_up,
            "depth_initial": base.depth}
