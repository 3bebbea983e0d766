"""Training: losses, the optimizer and one train step (atvsnet_tpu/models/train.py).

Supervision is a masked L1 in sweep (inverse-depth) space on the aggregated and the
refined depth maps, plus the per-pair swapped depths (`aux_view_loss`, or their own
ground truth with multi-depth samples), plus an optional confidence term.

The optimizer is the JAX package's optax chain written out step for step:
clip_by_global_norm -> add_decayed_weights -> adam, at a constant learning rate or a
warmup-cosine schedule. It keeps optax's arithmetic where the two could differ:
  * clipping is where(norm < max, g, g / norm * max); torch.nn.utils.clip_grad_norm_
    divides by norm + 1e-6 and clamps, which is another step;
  * the schedule is read at the count before the step's increment, and the cosine
    horizon includes the warmup;
  * a parameter that the loss does not reach gets a zero gradient (JAX's gradient of it
    is exactly 0) and goes through the chain like every other.
Parameters, moments and the count live on the model's device; the update is applied to
the parameters in place.

The mesh-sharded train step of the JAX package (jit_sharded_train_step) belongs to the
multi-device slice and is not here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.geometry.warp import transform_depth, warp_by_depth
from atvsnet_torch.models.atvsnet import multi_view_forward_train
from atvsnet_torch.models.tvsnet import ATVSNet

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass
class AdamState:
    """Adam's moments per parameter (named as in model.named_parameters(), in the
    parameters' layout) and the number of steps taken, which the schedule reads too."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: ATVSNet
    opt_state: AdamState
    step: int = 0


class Optimizer:
    """make_optimizer's optax chain for one TrainConfig."""

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg

    def learning_rate(self, count: int) -> np.float32:
        """The rate of the step taken at `count`, in float32 as the optax schedule
        computes it: constant, or linear warmup from 0 joined to a cosine decay whose
        horizon is decay_steps - warmup_steps."""
        t = self.tcfg
        f32 = np.float32
        if t.lr_schedule != "cosine":
            return f32(t.learning_rate)
        peak, end = t.learning_rate, t.learning_rate * t.lr_final_fraction
        if count < t.warmup_steps:
            frac = f32(1) - f32(count) / f32(t.warmup_steps)
            return f32(0.0 - peak) * frac + f32(peak)
        steps = float(t.decay_steps - t.warmup_steps)
        alpha = 0.0 if peak == 0.0 else end / peak
        c = f32(min(count - t.warmup_steps, steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(steps)))
        return f32(peak) * (f32(1 - alpha) * cosine + f32(alpha))

    def init(self, model: ATVSNet) -> AdamState:
        zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        return AdamState(0, zeros, {n: z.clone() for n, z in zeros.items()})

    @torch.no_grad()
    def apply(self, model: ATVSNet, grads: Dict[str, torch.Tensor],
              state: AdamState) -> AdamState:
        """One step: updates the model's parameters in place and returns the new state."""
        t = self.tcfg
        params = dict(model.named_parameters())
        if t.grad_clip_norm:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if not bool(norm < t.grad_clip_norm):
                grads = {n: (g / norm) * t.grad_clip_norm for n, g in grads.items()}
        if t.weight_decay:
            grads = {n: g + t.weight_decay * params[n] for n, g in grads.items()}
        count = state.count + 1
        # bias corrections and the rate as float32 scalars, as optax computes them
        f32 = np.float32
        bc1 = float(f32(1) - f32(ADAM_B1) ** count)
        bc2 = float(f32(1) - f32(ADAM_B2) ** count)
        lr = float(self.learning_rate(state.count))
        mu, nu = {}, {}
        for n, g in grads.items():
            mu[n] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[n]
            nu[n] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[n]
            update = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + ADAM_EPS)
            params[n].add_(update * -lr)
        return AdamState(count, mu, nu)


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    return Optimizer(tcfg)


def init_train_state(model: ATVSNet, optimizer: Optimizer) -> TrainState:
    """Unfreeze `model` (load_model and init_model return it frozen) and start at step 0."""
    model.requires_grad_(True)
    return TrainState(model, optimizer.init(model), 0)


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, interval: torch.Tensor,
              extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |pred - gt| / depth_interval over gt-valid pixels (MVSNet-style).

    pred, gt: (B, h, w, 1) in sweep space; interval: (B,); extra_mask: an optional
    further (B, h, w, 1) validity (e.g. a warp's in-bounds mask).
    """
    f32 = torch.float32
    valid = (gt > 0).to(f32)
    if extra_mask is not None:
        valid = valid * extra_mask.to(f32)
    err = (pred.to(f32) - gt.to(f32)).abs() * valid
    scale = interval.to(f32)[:, None, None, None]
    return torch.sum(err / scale) / torch.clamp(torch.sum(valid), min=1.0)


def aux_view_loss(depth_views: torch.Tensor, cams: torch.Tensor, gt: torch.Tensor,
                  interval: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Supervision of the per-pair swapped depths.

    depth_views[p] lives on view p+1's pixel grid in view p+1's frame. It is re-expressed
    in the reference frame (transform_depth) and resampled onto the reference grid at the
    ground-truth geometry (warp_by_depth, nearest), as refinement's geo-consistency error
    does; then the masked L1 where the warp is in bounds and both depths are valid. It is
    0 for view depths consistent with the ground truth.

    depth_views: (P, B, h, w, 1); cams: (B, N, 2, 4, 4); gt: (B, h, w, 1) sweep-space.
    """
    ref_cam = cams[:, 0]
    terms = []
    for p, depth_view in enumerate(depth_views):
        view_cam = cams[:, p + 1]
        dvt = transform_depth(depth_view, view_cam, ref_cam, cfg.inverse_depth)
        warped, m = warp_by_depth(dvt, ref_cam, view_cam, gt, cfg.inverse_depth,
                                  method="nearest", output_mask=True)
        valid = m.to(torch.float32) * (warped > 0).to(torch.float32)
        terms.append(masked_l1(warped, gt, interval, extra_mask=valid))
    return torch.stack(terms).mean()


def training_loss(model: ATVSNet, batch: dict, cfg: PipelineConfig, tcfg: TrainConfig):
    """(loss, metrics) of one batch: images (B, N, H, W, 3), cams (B, N, 2, 4, 4),
    depth_gt (B, h, w, 1) in sweep space, optionally depth_views_gt (B, N-1, h, w, 1)
    (multi-depth samples: each view's own-frame ground truth). Arrays or tensors; they
    go to the model's device. The loss reads native-resolution maps only, so the
    forward runs without the upsampled outputs."""
    need_conf = tcfg.loss_weight_confidence > 0
    out = multi_view_forward_train(model, batch["images"], batch["cams"], cfg,
                                   out_prob_map=need_conf, upsample=False)
    device = out["depth"].device

    def tensor(key):
        return torch.as_tensor(batch[key], dtype=torch.float32, device=device)

    cams, gt = tensor("cams"), tensor("depth_gt")
    interval = cams[:, 0, 1, 3, 1]
    loss = (tcfg.loss_weight_agg * masked_l1(out["depth_agg_initial"], gt, interval)
            + tcfg.loss_weight_refined * masked_l1(out["depth"], gt, interval))
    metrics = {}
    if need_conf:
        # peakiness: the mean 4-bin confidence at the regressed depth over gt-valid pixels
        # (the quantity the fusion filter thresholds), pushed towards 1
        valid = (gt > 0).to(torch.float32)
        conf = out["confidence"].to(torch.float32)
        conf_mean = torch.sum(conf * valid) / torch.clamp(torch.sum(valid), min=1.0)
        loss = loss + tcfg.loss_weight_confidence * (1.0 - conf_mean)
        metrics["confidence"] = conf_mean.detach()
    if "depth_views_gt" in batch:
        gt_views = tensor("depth_views_gt").movedim(1, 0)  # (P, B, h, w, 1)
        aux = torch.stack([masked_l1(d, g, interval)
                           for d, g in zip(out["depth_views"], gt_views)]).mean()
    else:
        aux = aux_view_loss(out["depth_views"], cams, gt, interval, cfg)
    loss = loss + tcfg.loss_weight_initial * aux
    return loss, {"loss": loss.detach(), "loss_aux": aux.detach(), **metrics}


def loss_and_grads(model: ATVSNet, batch: dict, cfg: PipelineConfig, tcfg: TrainConfig):
    """(loss, metrics, {parameter name: gradient}); a parameter that the loss does not
    reach gets zeros."""
    loss, metrics = training_loss(model, batch, cfg, tcfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), metrics, {n: torch.zeros_like(p) if g is None else g
                                    for n, p, g in zip(names, params, grads)}


def train_step(state: TrainState, batch: dict, cfg: PipelineConfig, tcfg: TrainConfig,
               optimizer: Optimizer):
    """One optimizer step on one batch: (the state, advanced in place, and the metrics)."""
    _, metrics, grads = loss_and_grads(state.model, batch, cfg, tcfg)
    state.opt_state = optimizer.apply(state.model, grads, state.opt_state)
    state.step += 1
    return state, metrics
