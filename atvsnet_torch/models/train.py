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

Over a mesh (parallel.mesh; sharded_train_step, the JAX package's jit_sharded_train_step)
the parameters and Adam's moments are replicated, each rank takes its rows of the batch
and its block of view pairs, and the gradients are summed over the world:
  * every denominator is the whole batch's: masked_l1's valid count and the confidence
    mean's are all-reduced over the 'data' group, and each rank's loss is its share, its
    rows' sums over those counts. The shares add up to the batch's loss; a mean of
    per-rank losses, as DDP takes, would weigh the ranks wrong whenever their counts differ;
  * every 'view' rank differentiates the same share (the stages after AAM run on each
    of them alike, and the view collectives send each rank's pairs the gradient of the
    others' copies), so the world's sum counts each data rank's gradient n_view times;
  * so does every 'depth' rank: the merged depths are the same on each, and the depth
    collectives (halos, summed statistics, the soft-argmin's merge) send each rank's
    planes the gradient of the others' copies. The world's sum counts each data rank's
    gradient n_view * n_depth times and is divided by that;
  * batch norm takes its statistics per sample and needs no collective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.geometry.warp import transform_depth, warp_by_depth
from atvsnet_torch.models.atvsnet import forward_stages
from atvsnet_torch.models.tvsnet import ATVSNet
from atvsnet_torch.parallel.mesh import Mesh

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


def batch_count(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """A count (or any value without gradient) summed over the 'data' group."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, interval: torch.Tensor,
              extra_mask: Optional[torch.Tensor] = None,
              group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Mean |pred - gt| / depth_interval over gt-valid pixels (MVSNet-style).

    pred, gt: (B, h, w, 1) in sweep space; interval: (B,); extra_mask: an optional
    further (B, h, w, 1) validity (e.g. a warp's in-bounds mask). With a 'data' group the
    rows are this rank's and the mean is this rank's share: its sum over the group's count.
    """
    f32 = torch.float32
    valid = (gt > 0).to(f32)
    if extra_mask is not None:
        valid = valid * extra_mask.to(f32)
    err = (pred.to(f32) - gt.to(f32)).abs() * valid
    scale = interval.to(f32)[:, None, None, None]
    return torch.sum(err / scale) / torch.clamp(batch_count(torch.sum(valid), group), min=1.0)


def aux_view_loss(depth_views: torch.Tensor, cams: torch.Tensor, gt: torch.Tensor,
                  interval: torch.Tensor, cfg: PipelineConfig,
                  group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Supervision of the per-pair swapped depths.

    depth_views[p] lives on view p+1's pixel grid in view p+1's frame. It is re-expressed
    in the reference frame (transform_depth) and resampled onto the reference grid at the
    ground-truth geometry (warp_by_depth, nearest), as refinement's geo-consistency error
    does; then the masked L1 where the warp is in bounds and both depths are valid. It is
    0 for view depths consistent with the ground truth.

    depth_views: (P, B, h, w, 1); cams: (B, N, 2, 4, 4); gt: (B, h, w, 1) sweep-space;
    group: as in masked_l1.
    """
    ref_cam = cams[:, 0]
    terms = []
    for p, depth_view in enumerate(depth_views):
        view_cam = cams[:, p + 1]
        dvt = transform_depth(depth_view, view_cam, ref_cam, cfg.inverse_depth)
        warped, m = warp_by_depth(dvt, ref_cam, view_cam, gt, cfg.inverse_depth,
                                  method="nearest", output_mask=True)
        valid = m.to(torch.float32) * (warped > 0).to(torch.float32)
        terms.append(masked_l1(warped, gt, interval, extra_mask=valid, group=group))
    return torch.stack(terms).mean()


def training_loss(model: ATVSNet, batch: dict, cfg: PipelineConfig, tcfg: TrainConfig,
                  mesh: Optional[Mesh] = None):
    """(loss, metrics) of one batch: images (B, N, H, W, 3), cams (B, N, 2, 4, 4),
    depth_gt (B, h, w, 1) in sweep space, optionally depth_views_gt (B, N-1, h, w, 1)
    (multi-depth samples: each view's own-frame ground truth). Arrays or tensors; they
    go to the model's device. The loss reads native-resolution maps only, so the
    forward (models.atvsnet.forward_stages with ref_depth=False, as parallel.pipeline's)
    runs without the upsampled outputs.

    With a mesh every rank passes the same whole batch and runs its rows and its pairs;
    the loss is then this rank's share of the batch's loss (see the module docstring),
    and the metrics are the whole batch's."""
    need_conf = tcfg.loss_weight_confidence > 0
    group = None if mesh is None else mesh.data_group
    if mesh is not None:
        batch = {k: mesh.data_rows(v) for k, v in batch.items()}
    layout = {} if mesh is None else mesh.forward_layout(cfg.view_num - 1, cfg.max_d)
    out = forward_stages(model, batch["images"], batch["cams"], cfg, ref_depth=False,
                         out_prob_map=need_conf, upsample=False, **layout)
    device = out["depth"].device

    def tensor(key):
        return torch.as_tensor(batch[key], dtype=torch.float32, device=device)

    cams, gt = tensor("cams"), tensor("depth_gt")
    interval = cams[:, 0, 1, 3, 1]
    loss = (tcfg.loss_weight_agg * masked_l1(out["depth_agg_initial"], gt, interval, group=group)
            + tcfg.loss_weight_refined * masked_l1(out["depth"], gt, interval, group=group))
    metrics = {}
    if need_conf:
        # peakiness: the mean 4-bin confidence at the regressed depth over gt-valid pixels
        # (the quantity the fusion filter thresholds), pushed towards 1; a rank's share
        # of the 1 is 1 / n_data
        valid = (gt > 0).to(torch.float32)
        conf = out["confidence"].to(torch.float32)
        conf_mean = torch.sum(conf * valid) / torch.clamp(
            batch_count(torch.sum(valid), group), min=1.0)
        one = 1.0 if mesh is None else 1.0 / mesh.n_data
        loss = loss + tcfg.loss_weight_confidence * (one - conf_mean)
        metrics["confidence"] = batch_count(conf_mean, group).detach()
    if "depth_views_gt" in batch:
        gt_views = tensor("depth_views_gt").movedim(1, 0)  # (P, B, h, w, 1)
        aux = torch.stack([masked_l1(d, g, interval, group=group)
                           for d, g in zip(out["depth_views"], gt_views)]).mean()
    else:
        aux = aux_view_loss(out["depth_views"], cams, gt, interval, cfg, group)
    loss = loss + tcfg.loss_weight_initial * aux
    return loss, {"loss": batch_count(loss, group).detach(),
                  "loss_aux": batch_count(aux, group).detach(), **metrics}


def loss_and_grads(model: ATVSNet, batch: dict, cfg: PipelineConfig, tcfg: TrainConfig,
                   mesh: Optional[Mesh] = None):
    """(loss, metrics, {parameter name: gradient}); a parameter that the loss does not
    reach gets zeros. With a mesh: the whole batch's loss and gradients, on every rank."""
    loss, metrics = training_loss(model, batch, cfg, tcfg, mesh)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    if mesh is not None:
        # one all-reduce of all the gradients over the world (see the module docstring)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= mesh.n_view * mesh.n_depth
        grads = [f.view_as(p) for f, p in zip(flat.split([p.numel() for p in params]), params)]
        loss = metrics["loss"]
    return loss.detach(), metrics, dict(zip(names, grads))


def train_step(state: TrainState, batch: dict, cfg: PipelineConfig, tcfg: TrainConfig,
               optimizer: Optimizer, mesh: Optional[Mesh] = None):
    """One optimizer step on one batch: (the state, advanced in place, and the metrics).
    With a mesh every rank passes the same whole batch and takes the same step."""
    _, metrics, grads = loss_and_grads(state.model, batch, cfg, tcfg, mesh)
    state.opt_state = optimizer.apply(state.model, grads, state.opt_state)
    state.step += 1
    return state, metrics


def sharded_train_step(mesh: Mesh, cfg: PipelineConfig, tcfg: TrainConfig, optimizer: Optimizer):
    """The train step over `mesh` (jit_sharded_train_step of the JAX package):
    step(state, batch) on every rank with the same whole batch. Parameters and moments are
    replicated, so every rank must start from the same weights (one file, or one seed)."""

    def step(state: TrainState, batch: dict):
        return train_step(state, batch, cfg, tcfg, optimizer, mesh)

    return step
