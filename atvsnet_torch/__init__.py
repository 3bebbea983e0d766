"""atvsnet_torch: the A-TVSNet pipeline in PyTorch, with hand-written CUDA kernels for Hopper.

A port of atvsnet_tpu (JAX), which stays the numerical reference. This package imports
torch and numpy only: never jax, and nothing of atvsnet_tpu.

Entry points:
  serving.DepthEstimator          frames and cams in, un-padded metric depth and
                                  confidence out, from one device-resident model
  cli.example                     python -m atvsnet_torch.cli.example: an example/{i}
                                  directory in, pred.npy, pred.jpg and the error report out
  cli.eval_errors                 the 14 depth-error metrics of two .npy/.pfm maps
  cli.eval_pointcloud             run_eval_pc / python -m atvsnet_torch.cli.eval_pointcloud:
                                  ETH3D-format scenes in; per reference image a depth and a
                                  confidence .pfm, the reference jpg, its cam and a png out
  fusion.fuse.fuse_scene, cli.depth_fusion
                                  that output folder in, final3d_model.ply out: confidence
                                  filter, multi-view consistency check, one point cloud
  cli.reproduce_pc                both in a row, for a list of scenes
  fusion.consistency.fuse_depth_maps
                                  depth maps, images and cams (or raw P matrices) in,
                                  points and colours (and normals) out; dense or sparse
  models.atvsnet.multi_view_forward, models.tvsnet.two_view_forward
                                  the bare forwards on prepared arrays (every N-view entry
                                  point runs models.atvsnet.forward_stages)
  cli.train, models.train         python -m atvsnet_torch.cli.train: training on rendered
                                  scenes, MVS-Synth or ETH3D; the losses, the optimizer,
                                  train_step; utils.ckpt: train-state checkpoints
  parallel.mesh.make_mesh, parallel.pipeline.multi_view_forward_spmd / sharded_forward
                                  the ('data', 'view') mesh over torch.distributed, one
                                  process per device; DepthEstimator, run_eval_pc and
                                  models.train take it as `mesh`
  params.load_model / init_model / save_params
                                  weights from and to the JAX package's .npz
  data.preprocess, data.cams, data.pfm, data.mvs_list, eval.errors
                                  the host-side readers, preparation policy and metrics
  data.colmap, data.mvs_syn, data.gipuma_io, fusion.ply, fusion.dmb
                                  COLMAP and MVS-Synth readers, gipuma-format files, PLY
  geometry.visual_hull.get_visual_hull
                                  the free-space hull of a stack of depth maps
  native                          the C++/OpenMP host library (compaction, back-projection,
                                  PLY writer), built with g++ into build/atvsnet_torch/
  utils.profiling                 StageTimer (wall-clock stages) and device_trace (a
                                  torch.profiler trace under a logdir)

Public helpers that no path calls, as the JAX package exports them:
  geometry                        split_cam, camera_center, depth_range_from_cams,
                                  homography_warp and the warps, homographies and depth
                                  regression that atvsnet_tpu.geometry exports
  models.tvsnet                   build_cost_volume (the explicit cost volume),
                                  aam_aggregate and cost_volume_aggregation (AAM over
                                  view-trailing (B, D, h, w, C, P) volumes)
  nn.aam                          attention_activation, attention_aggregate (view-trailing),
                                  Attention2D and attention_activation_2d
  nn.layers                       l2_pool_same, dense, dropout, l2_normalize,
                                  split_separable_conv2d

Those that run the model take a `device`. Left out, it is "cuda", and a machine without
CUDA raises instead of running on the CPU; tests pass device="cpu".
"""

from __future__ import annotations

import torch

from atvsnet_torch.config import PipelineConfig

__all__ = ["PipelineConfig", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA when None (never a CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "atvsnet_torch runs on CUDA by default and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        device = "cuda"
    return torch.device(device)
