"""The SPMD pipeline (atvsnet_tpu/parallel/pipeline.py): the N-view forward with its batch
split over a mesh's 'data' ranks and its view pairs over the 'view' ranks.

The stages are models.atvsnet.forward_stages with ref_depth=False, as the JAX package's
SPMD forward arranges them: one soft-argmin per pair in stage 1, stages 1 and 3 pair by
pair whatever cfg.pair_batch says, cfg.remat while autograd records.

Under a mesh each rank runs its rows of the batch and its block of pairs
(Mesh.forward_layout): the feature towers for the reference and its own views only, stages
1 and 3 for its pairs, AAM1 and AAM2 over the view group's all-reduces, and the rest of
stages 2 and 4 on every view rank alike. The pair-stacked outputs are gathered over the
view group, so every rank returns all P pairs of its rows.

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

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models.atvsnet import forward_stages
from atvsnet_torch.models.tvsnet import ATVSNet
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
    layout = {} if mesh is None else mesh.forward_layout(cfg.view_num - 1, cfg.max_d)
    return forward_stages(model, images, cams, cfg, ref_depth=False, out_prob_map=out_prob_map,
                          upsample=upsample, **layout)


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
