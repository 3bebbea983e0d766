#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (atvsnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device     nvidia-smi name and power limit, torch and CUDA versions
  2. build      nvcc builds atvsnet_torch/csrc/softargmin.cu, csrc/int8_conv.cu,
                csrc/conv2d_fp32.cu, csrc/conv3d_fp32.cu, csrc/conv3d_transpose_fp32.cu
                and csrc/plane_sweep.cu into
                build/atvsnet_torch/, one nvcc per source, all at once
  3. kernel     the CUDA soft-argmin against its plain PyTorch version (rtol 1e-5, atol
                1e-6, NaN at the same pixels) at the main paths' shapes (the train
                shape (1,32,32,40) in fp32 and bf16 among them), at edge shapes
                (odd h*w, D = 1, 12, 130, B = 3, a pointer that is not 16-byte aligned)
                and on volumes with planes of +inf cost; each line names the kernel's
                path, "aligned" (16-byte loads) or "scalar", and the path's counter is
                checked; each case also asks for the softmax statistics that autograd
                saves: the same depth to the bit, the max to the bit and the sum at rtol
                1e-5 against softargmin_partial_torch at offset 0. Then the gradient
                kernel (direction "backward", through softargmin_backward_cuda with the
                plain forward's statistics) against the closed-form plain backward (fp32
                rtol 1e-5, bf16 one bf16 ulp, atol 1e-6 of the largest gradient) and
                against autograd of the plain forward (atol 1e-5 * max|g| * max|sweep|),
                at the train shape (1,32,32,40), the flagship's shapes, D not a multiple
                of the kernel's chunk of planes, B = 2, odd h*w, D = 1 and 130, a
                misaligned pointer, +inf planes. Then the int8 conv kernel of
                act_quant="int8mxu" (conv3d_int8_cuda) against conv3d_int8_torch to the bit,
                int32, fp32 and bf16 out: every shape class of the flagship forward
                (INT8_MAIN_SHAPES: Co = 1, the AAM stack's B = 4), odd sizes, B = 2, Ci of
                4-byte and byte loads, and a depth split's blocks with their halo (D pads 0);
                each case's launch plan checked by the C side first and its path named
                (ring, ring_cluster or generic), and the other ring path, forced, held to
                the int32 sums too
  4. small      a 3-view 64x96 D32 forward on trained weights, on the GPU (kernel) and on
                the CPU (plain path): the two must agree and recover the rendered scene
  5. forward    multi_view_forward at 5 views, 480x896, D=128, fp32, with the trained
                spheres weights on synthetic_scene(seed=0): shapes, finiteness, exactly
                14 kernel launches, all on the aligned path, 137 launches of the fp32 conv2d
                kernel (every "highest" 2D conv) and 228 of the fp32 conv3d kernel (every
                "highest" 3D conv), 84 of the fp32 transposed conv3d kernel (every
                "highest" 3D deconv, 21 a pair, all on its vector path; none in a forward
                under fp32_precision="default"), 20 of the plane-sweep sampler (5 a pair; by
                path as SWEEP_FORWARD_PATHS), and agreement with softargmin_impl="torch"
                (both with cuDNN's deterministic algorithms); then the same forward under
                act_quant="int8mxu": every qin conv on the int8 kernel, 196 launches by
                shape as INT8_MAIN_SHAPES and by path as the planner says (none generic),
                the soft-argmin's 14 as before, the conv3d kernel's 32 (the float entry
                convs that are not qin), the transposed conv3d kernel's 84
  6. timing     steady-state forward time and peak memory (default and deterministic
                cuDNN algorithms); the forward with the port's activation
                (torch.maximum(y, 0), the JAX package's tie rule) against torch.relu, in
                turns; and per-shape kernel times beside the plain version's, the HBM
                bound and an empty launch of the same grid (the forward also with its
                statistics at the flagship's fp32 shapes and the train shape in bf16);
                the int8 conv at each INT8_MAIN_SHAPES class, fp32 and bf16 out, beside its
                bound, an empty launch of its grid, the other ring path (fp32), the plain
                version, the library call (cuDNN's conv with TF32 allowed on the int8 values
                held as float32: the same sums below 2^24, held to the kernel's to the bit)
                and cuDNN's float conv with TF32 off (the conv the int8 route replaces);
                the fp32 conv2d kernel (phase "conv2d") at every class of the 5-view and
                8-view forwards at 480x896 (recorded from each forward's shape counter):
                held to the float64 product within 8 sqrt(K) 2^-24 of max sum |a||b|, equal
                bits on a second call, kernel ms beside its bound, the call with its weight
                packing, the plain version (the route's call before the kernel) and one
                cuDNN conv with TF32 off (library), and their sums per forward; the fp32
                conv3d kernel (phase "conv3d") the same way at every class of both forwards;
                the fp32 transposed conv3d kernel (phase "deconv3d") the same way at its
                three classes of both forwards (K = 8 Ci; bound: input, weights and cropped
                output once against 2 * 27 Ci Co FLOPs an input cell), beside the plain
                version and one cuDNN conv_transpose3d with TF32 off (the pre-change call:
                dgrad and fill);
                the plane-sweep sampler (phase "sweep") at every class of both forwards, on
                the inputs of the class's first launch there: equal to the plain version
                (ops.plane_sweep.sample_torch) to the bit in fp32 and with the image in bf16,
                equal bits on a second call, kernel ms beside its bound (coordinates, source
                map, outputs and mask moved once) and the plain version, and their sums
  7. profile    device time of one forward by kind of kernel, and its top kernels
                (torch.profiler); the idle share is read against a CUDA-event bracket; the
                same for the int8mxu forward
  8. pair_batch the same forward with pair_batch=True against pair_batch=False (cuDNN's
                deterministic algorithms): depths agree within the bounds stated at
                BATCH_MEAN_DIFF, the launches per volume shape are as reckoned, seconds (in
                turns, both kinds of cuDNN algorithm) and peak memory of each; then the
                forward stage by stage (seconds and peak memory of each stage), with
                stages 1 and 3 batched against per pair on the same inputs
  9. serving    serving.DepthEstimator at the same size: warmup, predict on uint8 frames
                (shapes, finiteness, launches, agreement with the bare forward on the same
                prepared inputs), a second bucket that pads a 250x300 request, predict_many
                against predict, median runtime_s of 5 requests, an off-bucket
                preprocessed request that must raise
 10. example    cli.example.run_example on an example/0 directory written into a temp dir
                (5 rendered views, 480x896, D=128): the files, a finite error report
 11. native     g++ builds native/atvsnet_native.cpp into build/atvsnet_torch/; the library
                must load, and each function is held against its numpy version
 12. fusion     fusion.consistency.fuse_depth_maps on a rendered 12-view scene with known
                depths (120x224, ~20% of pixels zeroed; then 480x896): dense equals sparse
                exactly, the card against device="cpu" within the flip bound, seconds per
                scene, points, the split upload / device / download / host compaction, and
                the 480x896 scene once more with 50% and 10% of the pixels left
 13. eval       cli.eval_pointcloud.run_eval_pc on a fabricated ETH3D scene (12 images,
                512x640, 3 spheres) at 8 views, D=128, full width, fp32, trained weights:
                soft-argmin launches per shape and path, every depth map scored against the
                scene's ground truth, maps/s, the blocked-time split, peak memory; batch=2
                against batch=1; then fusion.fuse.fuse_scene at its defaults: point count
 14. train      training at the train CLI's default size (3 views, 128x160, D=32): (a) one
                fp32 training_loss + backward through the kernels against impl="torch"
                on the same inputs and spheres weights (deterministic cuDNN): loss rtol
                1e-5, gradients within 5e-3 globally, soft-argmin launches per shape and
                direction with the confidence term off and on and with remat; (b) the
                same step on device="cpu": loss rtol 1e-4; (c) cli.train.main for 30
                steps at its defaults (bf16) from init_model: finite losses, steps/s, the
                first step's seconds, peak memory, launches, --resume, the exported
                params load and run; (d) one fp32 step at 5 views, 480x896, D=128 with
                the spheres weights, remat off and on: seconds and peak memory
 15. parallel   the multi-device layer (atvsnet_torch.parallel), its ranks child processes:
                (a) a world of 2 ranks sharing cuda:0 over gloo (NCCL takes one rank per
                card) runs the flagship forward (5 views, 480x896, D=128, fp32, spheres
                weights, deterministic cuDNN) on a view=2 mesh and on a data=2 mesh (a
                batch of 2), each held against the forward in one process within the
                BATCH_MEAN_DIFF bounds; soft-argmin launches per rank and shape, seconds
                and peak memory per rank; (b) the sharded train step at the train size on
                the same world, data=2 (the two rows' ground truth of different density)
                and view=2, against the step in one process (loss rtol 1e-4, gradients 5e-3);
                (c) a world of torch.cuda.device_count() ranks, one per card, over NCCL:
                the flagship forward on an auto_mesh_shape(count, 4) mesh, held as in (a);
                (d) the eval CLI under torchrun, --mesh data=<count>, on a rendered
                4-image 256x320 scene at 5 views, D=128: the files of an unsharded
                run_eval_pc, the depth maps within the BATCH_MEAN_DIFF bounds
 16. quant      each quantization (act_quant int8, int8s and int8mxu, warp_quant int8,
                int8s + int8): phase_small's forward on the card against the CPU (bounds
                QUANT_MEAN_DIFF, QUANT_MAX_DIFF); then the flagship forward (deterministic
                cuDNN) in turns with the unquantized forward: median seconds of 5, peak
                memory, |depth - unquantized depth| mean and max in sweep units; and at
                the same size on a rendered scene, the depth moved and its error against
                the ground truth. A second card-against-CPU line runs bench.py's default
                mode, bf16 with int8s links and int8 warps, and int8mxu in bf16, at the
                same bounds
 17. depth      the 'depth' mesh axis (parallel.depth): (a) the flagship forward on a
                depth=2 mesh, 2 ranks sharing cuda:0 over gloo, and on (1, 2, 2), 4 ranks
                each held to SHARED4_MEMORY_FRACTION of the card, against one process within
                the BATCH_MEAN_DIFF bounds, with the depth-split kernels' launches per rank
                and shape; (b) a world of device_count() ranks over NCCL, D split over as
                many as it divides (1 on one card); (c) the train-size fp32 loss and
                backward on depth=2 against one process (loss rtol 1e-4, gradients 5e-3),
                4 and 4 launches of the two depth-split kernels per rank; (d) the flagship
                fp32 train step, remat on, on depth=2: seconds and peak memory per rank
 18. precision  PipelineConfig.fp32_precision (ops.fp32_passes): (a) every leaf kind at
                the flagship's shapes (the FEM's first 2D conv at 480x896, a dilated
                residual conv, CRM 3D convs at stride 1 and 2, the 3D deconv, the AAM conv,
                a depthwise conv, a dense matmul) in "high" and "default", forward,
                grad_input and grad_weight, against the float64 plain version of the mode:
                error over max sum |a||b| within max(2^-20, 4 e), e the "highest" call's
                own error against the exact product; plain TF32's error beside it must miss
                that bound on the forward and grad_input; the TF32 flags as before after every call; "highest" equal to
                the TF32-off call to the bit; forward ms per mode and for plain TF32;
                (b) the 3-view 64x96 D32 trained forward per mode on the card against the
                CPU (PRECISION_SMALL_BOUNDS); (c) the flagship forward per mode in turns
                (deterministic cuDNN): median seconds of 5, peak memory, the cuDNN/cuBLAS
                ms of one profiled forward and its top kernels (TF32 kernels by name),
                14 soft-argmin launches each, the depth moved against "highest" on the
                noise scene and on a rendered scene, the rendered scene's error; (d) one
                fp32 train step per mode at the train CLI's size: loss and gradients
                against "highest", seconds, launches
 19. helpers    the JAX package's public helpers that no path calls (camera_center,
                depth_range_from_cams, homography_warp, build_cost_volume, the view-trailing
                and 2D AAM forms, aam_aggregate, cost_volume_aggregation, l2_pool_same,
                dense, l2_normalize, split_separable_conv2d), each on the card against the
                same call on the CPU (HELPER_REL; homography_warp's mask equal); dropout by
                its statistics; StageTimer; device_trace's trace of a CUDA block
The kernel phase also holds the depth-split entry points (the partial forward, its own
kernel on a grid of pixel tiles x chunks of D whose chunks form a thread-block cluster;
the stats-fed backward: the gradient kernel at the slice's offset) against their plain
versions at the flagship's depth=2 slices (SPLIT_SHAPES), fp32 and bf16, a slice whose D
neither kernel's chunking divides, the depth phase's train slice (B = 2) in both dtypes,
clusters of 2 (the scalar path), 4 (B = 2, h*w no multiple of the partial kernel's tile)
and 8, an all-+inf slice and a misaligned one, each line with both grids; timing times
them beside their bounds, an empty launch of their grid and torch.amax over D of the
same volume.
Then the nvidia-smi line, the kernels line, and last {"ok": true, "device": {...}}.

It needs CUDA: without it, it exits non-zero before printing any result. It imports
nothing of JAX or of atvsnet_tpu. `--only kernels int8 conv2d conv3d deconv3d sweep native
fusion eval train parallel quant depth precision helpers` runs just those phases after device
and build (kernels: every kernel check and kernel timing above; int8: the int8 conv's checks,
the flagship int8mxu forward and its profile, the int8 conv's times; conv2d, conv3d,
deconv3d, sweep: the fp32 conv2d, conv3d or transposed conv3d kernel's or the plane-sweep
sampler's checks and times; depth with
the depth-split kernels' checks and times): a short run while working on one of them,
which exits 1 and prints no kernels line and no ok line. `--only kernels --baseline DIR` also times DIR's soft-argmin kernels (another
checkout, say the parent commit unpacked under build/) in turns with this tree's on the
same inputs; `--only int8 --baseline DIR` DIR's int8 conv kernel at every INT8_MAIN_SHAPES
class, fp32 and bf16 out.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import glob
import json
import math
import os
import queue
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import atvsnet_torch.geometry as geometry
from atvsnet_torch import native
from atvsnet_torch.cli import train as train_cli
from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
from atvsnet_torch.cli.example import run_example
from atvsnet_torch.config import FP32_PRECISION_MODES, PipelineConfig, TrainConfig
from atvsnet_torch.data import image_io
from atvsnet_torch.data.pfm import load_pfm
from atvsnet_torch.data.preprocess import prepare_mvs_sample
from atvsnet_torch.data.synthetic import (make_cam, render_multiplane_scene,
                                          render_multiplane_views, synthetic_scene,
                                          write_eth3d_scene, write_example_dir)
from atvsnet_torch.eval.errors import calc_error
from atvsnet_torch.fusion import consistency as fusion
from atvsnet_torch.fusion.fuse import fuse_scene, load_scene, probability_filter
from atvsnet_torch.fusion.ply import read_ply, write_ply
from atvsnet_torch.geometry.cameras import camera_center, scale_camera_np
from atvsnet_torch.models.atvsnet import (center_images, multi_view_forward,
                                          refine_pairs_batched, sweep_to_depth)
from atvsnet_torch.geometry.depth_regression import prob2depth, prob2depth_upsample
from atvsnet_torch.models.train import (init_train_state, loss_and_grads, make_optimizer,
                                        sharded_train_step, train_step)
from atvsnet_torch.models.tvsnet import (aam_aggregate, aam_aggregate_stacked, aam_output_conv,
                                         build_cost_volume, cost_volume_aggregation,
                                         extract_features, init_model, prepare_inputs,
                                         refinement, tvsnet_base)
from atvsnet_torch.nn import aam
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import conv2d_fp32 as C2
from atvsnet_torch.ops import conv3d_fp32 as C3
from atvsnet_torch.ops import conv3d_transpose_fp32 as CT
from atvsnet_torch.ops import fp32_passes
from atvsnet_torch.ops import int8_conv as I8
from atvsnet_torch.ops import plane_sweep as PS
from atvsnet_torch.ops import softargmin as S
from atvsnet_torch.params import load_model
from atvsnet_torch.parallel.mesh import auto_mesh_shape, make_mesh
from atvsnet_torch.parallel.pipeline import sharded_forward
from atvsnet_torch.serving import DepthEstimator
from atvsnet_torch.utils.profiling import StageTimer, device_trace

ROOT = os.path.dirname(os.path.abspath(__file__))
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
RTOL, ATOL = 1e-5, 1e-6
# Published HBM bandwidths and fp32 (non-tensor-core) peaks, NVIDIA data sheets.
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
FP32_FLOP_PER_S = {"sxm": 67e12, "pcie": 51e12}
FLOPS_PER_ELEMENT = 6  # negate, max, subtract, exp, add, multiply-add per cost element
# main-path soft-argmin launches at 5 views, 480x896, D=128: 2 per pair x 4 pairs +
# AAM1 + the native final depth at (1,128,120,224); 4 row tiles at (1,128,120,896)
MAIN_SHAPES = {(1, 128, 120, 224): 10, (1, 128, 120, 896): 4}
EXPECTED_LAUNCHES = sum(MAIN_SHAPES.values())
# the same forward with out_prob_map=True, which DepthEstimator serves: a confidence map
# needs the whole softmax volume, so AAM1, the native final depth and the 4 row tiles go
# through the plain formula (geometry/depth_regression.prob2depth) and only stage 1's
# 2 per pair x 4 pairs launch the kernel
PROB_MAP_SHAPES = {(1, 128, 120, 224): 8}
# the same forward with pair_batch=True: stage 1 sends both directions of a pair as one
# (2, D, h, w) volume, 1 launch per pair x 4 pairs; AAM1, the native final depth and the
# 4 row tiles as in MAIN_SHAPES
PAIR_BATCH_SHAPES = {(2, 128, 120, 224): 4, (1, 128, 120, 224): 2, (1, 128, 120, 896): 4}
# peak memory of the pair_batch=True forward as reckoned BEFORE its first run on a card,
# from the sequential forward's 23.2 GB taken to be one CRM pass and its cuDNN workspace:
# stage 1 doubles the batch, stage 3 quadruples a ~1.5 GB working set, so at most twice.
# It is printed beside the measured peak, which showed the premise wrong: the 23.2 GB is
# the FEM's, and batching the pairs does not move it (PERF.md).
PAIR_BATCH_PEAK_RECKONED = 2 * 23.2e9
# kernel vs plain soft-argmin inside the full forward, both with cuDNN's deterministic
# algorithms: its default ones are not run-to-run reproducible, and refinement turns
# their noise into flipped nearest-rounding and visual-hull decisions (on an H100 80GB
# HBM3, 700 W, with the default algorithms the kernel and plain forwards differed by
# 2.2e-4 to 0.025 at 0.10% to 2.5% of final-depth pixels over five runs). With the
# deterministic ones the kernel alone moved the final depth by at most 5.6e-5 sweep
# units (same card). Bounds: 1e-3
# at most, and beyond DIFF_AT at most 0.5% of pixels, where a ~1e-6 gap may still flip
# a rounding; a systematic error would move most pixels.
DIFF_AT, MAX_DIFF_SHARE, MAX_DIFF = 1e-4, 0.005, 1e-3
DEPTH_KEYS = ("depth", "depth_up", "depth_agg_initial", "depth_views")
# A batched pass against the unbatched one (pair_batch, predict_many), both with cuDNN's
# deterministic algorithms: cuDNN picks other algorithms at another batch size, so the
# same stage on the same inputs differs by up to 3.4e-5 of its scale (measured on an H100
# 80GB HBM3, 700 W: stage-1 volumes 8.4e-4 at scale 24.6, refinement residuals 2.0e-4 at
# scale 16.8), and refinement's nearest-rounding and visual-hull decisions flip on that noise,
# as they do run to run with the default algorithms. Measured there on this noise-image
# scene: the final depth of pair_batch=True against False differs by 2.0e-4 on average,
# at 26% of pixels beyond 1e-4, at 0.23% beyond 1e-2, at most by 0.067. So what precedes
# refinement (depth_views, depth_agg_initial) is held to the bounds above, stage 1 and
# stage 3 batched against per pair on the SAME inputs to STAGE_REL_DIFF of the output's
# scale, and the final depths to: mean difference at most BATCH_MEAN_DIFF, beyond
# BATCH_DIFF_AT at most BATCH_MAX_SHARE of pixels. A wrong pairing of volumes, cameras or
# statistics would move every pixel by far more.
STAGE_REL_DIFF = 3e-4
BATCH_MEAN_DIFF, BATCH_DIFF_AT, BATCH_MAX_SHARE = 1e-3, 1e-2, 0.01
# GPU (kernel, cuDNN) vs CPU (plain, oneDNN) at the small size with trained weights:
# measured 4.8e-7 sweep units; bound 1e-4
SMALL_MAX_DIFF = 1e-4
# DepthEstimator.predict against the bare forward on the same prepared inputs, both with
# cuDNN's deterministic algorithms: the same kernels on the same values, so metric depths
# and confidences (away from integer bin indices) are held to 1e-5
SERVING_MAX_DIFF = 1e-5
# The eval path: run_eval_pc at 8 views, 512x640, D=128, with the confidence map and without
# the upsampled outputs. Stage 1 launches the kernel twice per pair (7 pairs); AAM1's and
# the final depth need the whole softmax volume for the confidence and go through the plain
# formula. 14 launches per forward at (1,128,128,160), 12 reference images.
EVAL_IMAGES, EVAL_VIEWS, EVAL_H, EVAL_W = 12, 8, 512, 640
EVAL_SHAPES = {(1, 128, EVAL_H // 4, EVAL_W // 4): 2 * (EVAL_VIEWS - 1) * EVAL_IMAGES}
EVAL_BATCH2_SHAPES = {(2, 128, EVAL_H // 4, EVAL_W // 4): 2 * (EVAL_VIEWS - 1) * EVAL_IMAGES // 2}
# Bounds on the eval phase's accuracy, stated before its first run on a card: a sanity range
# around the committed record of this scene (MAE 1.74 mm, inlier@3% 96.1%, 200,741 points;
# taken in bf16 on another device at an unrecorded view count), not a target.
EVAL_MAX_MAE, EVAL_MIN_INLIER3, EVAL_MIN_POINTS = 0.01, 0.90, 100_000
# The card against device="cpu" in the consistency check: `rel < disp_thresh` compares fp32
# values whose rounding differs between the two, so a pixel within an ulp of the threshold
# may emit on one and not the other. Points only one cloud has: at most 0.1% of the larger
# cloud; matched points are bit-equal (both come from the host's float64 back-projection
# of the same pixel) and their colours agree to +-1.
FUSION_MAX_UNMATCHED, FUSION_COLOUR_TOL = 1e-3, 1
FUSION_FLOP_PER_CHECK = 60  # per (reference pixel, view): project, 4-corner blend of 4 channels, test
# The gradient kernel: per cost element the exponent's argument, the exponent, the sweep
# difference and two products, in one pass; it reads the cost and writes its gradient.
BWD_FLOPS_PER_ELEMENT = 6
# Bounds of the backward kernel, stated before its first run on a card. Against the
# closed-form plain backward: fp32 rtol 1e-5 (ex2.approx and the order of two products),
# bf16 one bf16 ulp (both round the same fp32 formula); atol 1e-6 of the largest gradient
# (values the kernel's flush-to-zero exponent makes 0). Against autograd of the plain
# forward: atol 1e-5 * max|g| * max|sweep|, since that formula subtracts two values of
# that size (p * (g * sweep - sum p * g * sweep)).
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# Training at the train CLI's default size, the size the committed weights were trained at.
TRAIN_SIZE = dict(view_num=3, max_d=32, max_h=128, max_w=160)
TRAIN_SHAPE = (1, 32, 32, 40)
# soft-argmin launches per training loss and backward at 3 views, keyed (remat, confidence
# weight) -> (forward, backward): stage 1 one per pair (the reference direction's depth is
# in no loss), AAM1's, and the final depth's unless the confidence term sends it through
# the plain confidence formula; remat recomputes stage 1 in the backward
TRAIN_LAUNCHES = {(False, 0.0): (4, 4), (False, 0.5): (3, 3), (True, 0.0): (6, 4)}
# kernel route against impl="torch" on the card (deterministic cuDNN), held to the CPU
# tests' bounds against JAX (tests/test_torch_train.py): loss rtol 1e-5, the gradients'
# global relative difference 5e-3; the card against device="cpu": loss rtol 1e-4
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_CPU_LOSS_RTOL = 1e-5, 5e-3, 1e-4
CLI_STEPS = 30
# The parallel phase. Soft-argmin launches of one rank's sharded flagship forward (the
# parallel.pipeline forward: stage 1 launches once per pair, for the swapped direction
# only, as the JAX SPMD forward computes it; AAM1 and the native final depth once each;
# the 4 row tiles), for a rank with `pairs` pairs: 2 on a view=2 mesh (8 launches), all 4
# on a data=2 one (10). multi_view_forward's 14 include each pair's reference-direction
# depth, which no output of the sharded forward reads.
def parallel_shapes(pairs: int) -> dict:
    return {(1, 128, 120, 224): pairs + 2, (1, 128, 120, 896): 4}


# the sharded train step against the step in one process: train (a)'s bounds
PARALLEL_LOSS_RTOL, PARALLEL_GRAD_REL = 1e-4, 5e-3
PARALLEL_RESULT_TIMEOUT_S = 400
PARALLEL_EVAL = dict(view_num=5, max_d=128, max_h=256, max_w=320)
# The quant phase: the flagship forward (deterministic cuDNN) under each storage
# quantization, in turns with the unquantized one: seconds, peak memory, and how far the
# quantization moves the depth (no bound: on the noise images of synthetic_scene the
# softmax over D is flat and the depth moves by whole planes, see PERF.md). The card's
# quantized forward is bounded against the same forward on the CPU, at phase_small's size
# with the trained weights on a rendered scene, as tests/test_torch_quant.py bounds the
# port's quantized forward against the JAX package's (mean 2e-3, max 1e-2 sweep units): a
# value within float noise of a lattice tie lands one step away, and the U-Nets and
# refinement amplify that step.
QUANT_MODES = {"act int8": dict(act_quant="int8"), "act int8s": dict(act_quant="int8s"),
               "act int8mxu": dict(act_quant="int8mxu"), "warp int8": dict(warp_quant="int8"),
               "act int8s + warp int8": dict(act_quant="int8s", warp_quant="int8")}
QUANT_ROUNDS = 5
QUANT_MEAN_DIFF, QUANT_MAX_DIFF = 2e-3, 1e-2
# bench.py's default mode, bf16 with int8s links and int8 warps, on the card against the CPU
# at the same size and bounds (tests/test_torch_quant_bf16.py holds it against JAX)
QUANT_BF16_MODES = {"act int8s + warp int8, bf16": dict(act_quant="int8s", warp_quant="int8",
                                                          compute_dtype="bfloat16"),
                    "act int8mxu, bf16": dict(act_quant="int8mxu", compute_dtype="bfloat16")}
# The precision phase (PipelineConfig.fp32_precision, ops.fp32_passes). (a) Every leaf kind
# at the flagship's shapes, forward and both gradients, against its float64 plain version:
# the error over max sum |a||b| within max(2^-20, 4 e), e the "highest" call's own error
# against the float64 exact product at the same shape in the same run (the fp32 sums'
# noise; grad_weight sums over millions of positions); plain TF32's error beside it must
# exceed that bound on the forward and grad_input (the check tells the modes from TF32).
# (b) The small trained forward on the card against the CPU per mode: "highest" and
# "high" at phase_small's fp32 bound
# (measured on the CPU: "high" moves the trained forward by fp32 noise only), "default" at
# the CPU test's bound against JAX (tests/test_torch_precision.py: every conv rounds its
# operands to bf16, and an fp32-noise difference that crosses a rounding tie moves a value
# by a bf16 step). (c) The flagship forward per mode in turns, (d) a train-size fp32 step
# per mode: readings, not bounds.
PRECISION_FLOOR = 2.0 ** -20
PRECISION_SMALL_BOUNDS = {"highest": (2e-5, 1e-4), "high": (2e-5, 1e-4),
                          "default": (4e-4, 6e-3)}
PRECISION_ROUNDS = 5
# The helpers phase: the JAX package's public helpers that no path calls, each on the card
# against the same call on the CPU. fp32 with TF32 off, so they differ only in the order
# of sums: the CPU tests' bound against JAX, 1e-5 of max(1, the largest value); the
# homography_warp mask equal everywhere (an off-axis homography keeps samples off the
# pixel lattice). Dropout draws from each device's own generator: it is held by its
# statistics (the kept share within 5 standard deviations of keep_prob).
HELPER_REL = 1e-5
HELPER_SIZE = dict(view_num=3, max_d=8, max_h=32, max_w=32)
HELPER_TRACE_BLOCKS = 50
# The depth phase. Launches of the depth-split kernels per depth rank of the flagship
# forward on a depth mesh (the parallel.pipeline forward: 1 per own pair in stage 1, AAM1's,
# the native final depth's at the native slice; the 4 row tiles), and per training loss
# and backward at the train size (3 views: 2 pairs, AAM1, the final depth).
def depth_shapes(pairs: int, n_depth: int) -> dict:
    d = 128 // n_depth
    return {(1, d, 120, 224): pairs + 2, (1, d, 120, 896): 4}


DEPTH_TRAIN_SHAPE = (2, 16, 32, 40)      # the 2-row train batch's volumes on depth=2
DEPTH_TRAIN_LAUNCHES = (4, 4)            # (partial forward, stats-fed backward)
# the flagship remat-on step on one process (PERF.md §5; an H100 80GB HBM3 at 700 W)
ONE_PROCESS_REMAT_STEP = {"seconds": 7.05, "peak_bytes": 31_742_019_584}
# each rank of the 4-rank world on one card keeps to this share of its memory, so that the
# four fit whatever workspace cuDNN would take (it tries smaller algorithms instead)
SHARED4_MEMORY_FRACTION = 0.23
# the depth-split kernels: per cost element of the partial forward the forward's work;
# the stats-fed backward is the gradient kernel (BWD_FLOPS_PER_ELEMENT)
# the shapes of the flagship's depth=2 split (native slice and row tile), held against the
# plain versions; the slice at offset 64 is the second rank's
SPLIT_SHAPES = ((1, 64, 120, 224), (1, 64, 120, 896))
# the flagship forward with each activation, in this order: every relu beside a maximum,
# first and last alike, so that a drift of the host's launch rate falls on both
ACTIVATION_ORDER = ("relu", "maximum", "maximum", "relu") * 3
# The int8 conv kernel of act_quant="int8mxu" (ops.int8_conv): its launches in one flagship
# forward (5 views, 480x896, D=128) by input (B, D, H, W, Ci) and (Co, stride). Every qin
# conv: per CRM pass (8: 2 directions x 4 pairs) the 19 trunk convs and the prob conv, per
# refinement (4) the 7 trunk convs and d_cost_vol, per AAM (2) the [unique | shared] conv
# of the 4-pair stack and the output conv, on the (128, 120, 224) volume and its halvings.
INT8_MAIN_SHAPES = {
    (1, 128, 120, 224, 8, 8, 1): 16,     # CRM b1/b2 0_1
    (1, 128, 120, 224, 8, 16, 2): 16,    # CRM b1/b2 1_0
    (1, 128, 120, 224, 8, 1, 1): 14,     # CRM prob (8), refine d_cost_vol (4), AAM output (2)
    (1, 128, 120, 224, 32, 8, 1): 4,     # refine 0_1
    (1, 128, 120, 224, 32, 16, 2): 4,    # refine 1_0
    (1, 64, 60, 112, 16, 16, 1): 28,     # 1_1: 3 per CRM pass, 1 per refinement
    (1, 64, 60, 112, 16, 32, 2): 28,     # 2_0
    (1, 32, 30, 56, 32, 32, 1): 28,      # 2_1
    (1, 32, 30, 56, 32, 64, 2): 28,      # 3_0
    (1, 16, 15, 28, 64, 64, 1): 28,      # 3_1
    (4, 128, 120, 224, 8, 16, 1): 2,     # AAM [unique | shared], relu
}
INT8_EXPECTED_LAUNCHES = sum(INT8_MAIN_SHAPES.values())   # 196
# Published dense int8 tensor-core peaks, NVIDIA data sheets.
INT8_OPS_PER_S = {"sxm": 1979e12, "pcie": 1513e12}
# an output scale of the size the route gives: (R / 127) * (max|w| / 127) at R = 6
INT8_SCALE = 6.0 / 127.0 * 0.4 / 127.0


# The fp32 conv2d kernel (ops.conv2d_fp32): launches per N-view forward (every float32 2D
# conv with groups 1 in "highest": the FEM's 62, the shallow FEM's 11, 16 per pair in CRM's
# and the refinement's D-constant halves), and its bound on |kernel - exact| over max sum
# |a||b| at a contraction of K: 8 sqrt(K) fp32 roundings (2^-24), the random walk of K
# sequential fp32 additions with room; TF32's 10-bit operands (2^-11 a product) lie far
# above it. tests/test_torch_conv2d_fp32.py holds the kernel to both.
def conv2d_forward_launches(views: int) -> int:
    return 62 + 11 + 16 * (views - 1)


def conv2d_kernel_bound(k: int) -> float:
    return 8.0 * math.sqrt(k) * 2.0 ** -24


CONV2D_VIEWS = (5, 8)        # the served cells' and the eval cell's forwards, at 480x896


# The fp32 conv3d kernel (ops.conv3d_fp32): launches per N-view forward (every float32 3D
# conv in "highest": AAM1's and AAM2's [unique | shared] and output convs, 4; per pair 56,
# the two CRM passes and the refinement), and those of the int8mxu forward (the float entry
# convs that are not qin: CRM's two per pass and the refinement's four, 8 a pair). The
# kernel is held to the bound of the 2D kernel, conv2d_kernel_bound(27 Ci).
def conv3d_forward_launches(views: int) -> int:
    return 4 + 56 * (views - 1)


def conv3d_int8mxu_launches(views: int) -> int:
    return 8 * (views - 1)


# The fp32 transposed conv3d kernel (ops.conv3d_transpose_fp32): launches per N-view forward
# (every float32 3x3x3 stride-2 deconv in "highest", under int8mxu too: CRM's 3 a U-Net pass
# in both directions and the refinement's 3, 21 a pair; none in "default"), and its classes
# at 480x896, D = 128: (name, ((B, D, H, W) of x, Ci, Co)), each with crop begins 0.
def deconv3d_forward_launches(views: int) -> int:
    return 21 * (views - 1)


DECONV3D_CLASSES = [
    ("_4_0 64->32", ((1, 16, 15, 28), 64, 32)),
    ("_5_0 32->16", ((1, 32, 30, 56), 32, 16)),
    ("_6_0 16->8", ((1, 64, 60, 112), 16, 8)),
]


# The plane-sweep sampler (ops.plane_sweep): launches per N-view forward, 5 a pair: CRM's two
# sweeps (bilinear, 32 channels), the refinement's sweep (bilinear over 17 channels, the
# nearest of the 17th and the mask) and its two 2D warps by depth (bilinear over 16 channels,
# nearest over 1). The kernel gives the plain version's bits (ops.plane_sweep.sample_torch).
def sweep_forward_launches(views: int) -> int:
    return 5 * (views - 1)


# launches a 5-view forward per "<kind>.<path>": CRM's sweeps and the 16-channel 2D warp on
# the vector path, the 17-channel and 1-channel sources on the scalar one
SWEEP_FORWARD_PATHS = {"bilinear.vector": 12, "bilinear_nearest.scalar": 4, "nearest.scalar": 4}


# (name, ((B, D, H, W) of x, Ci, Co, stride)): the classes of the 5-view forward at
# 480x896, D = 128 (TF-SAME pads: (1, 1) at stride 1, (0, 1) at stride 2)
CONV3D_CLASSES = [
    ("CRM entry, refine 0_1 32->8", ((1, 128, 120, 224), 32, 8, 1)),
    ("AAM [unique | shared] 8->16", ((4, 128, 120, 224), 8, 16, 1)),
    ("refine photo entry 16->8", ((1, 128, 120, 224), 16, 8, 1)),
    ("CRM 1_0, refine 1_0 32->16 s2", ((1, 128, 120, 224), 32, 16, 2)),
    ("CRM 0_x 8->8", ((1, 128, 120, 224), 8, 8, 1)),
    ("CRM 1_0 8->16 s2", ((1, 128, 120, 224), 8, 16, 2)),
    ("prob, d_cost_vol, AAM output 8->1", ((1, 128, 120, 224), 8, 1, 1)),
    ("refine geo entry 2->8", ((1, 128, 120, 224), 2, 8, 1)),
    ("prob / vis-hull entry 1->8", ((1, 128, 120, 224), 1, 8, 1)),
    ("1_1 16->16", ((1, 64, 60, 112), 16, 16, 1)),
    ("2_0 16->32 s2", ((1, 64, 60, 112), 16, 32, 2)),
    ("2_1 32->32", ((1, 32, 30, 56), 32, 32, 1)),
    ("3_0 32->64 s2", ((1, 32, 30, 56), 32, 64, 2)),
    ("3_1 64->64", ((1, 16, 15, 28), 64, 64, 1)),
]


def emit(**record):
    # numpy scalars (a bool from ndarray.all(), a float32 mean) go out as Python's
    print(json.dumps(record, default=lambda o: o.item()), flush=True)


def shape_counts(counts: dict) -> dict:
    """A {shape: launches} dict with keys JSON can carry."""
    return {"x".join(map(str, shape)): n for shape, n in counts.items()}


def depth_differences(a: dict, b: dict, keys) -> dict:
    """For each key: mean and max difference, and the shares of elements beyond DIFF_AT and
    beyond BATCH_DIFF_AT."""
    stats = {}
    for k in keys:
        d = (torch.as_tensor(a[k]) - torch.as_tensor(b[k])).abs()
        stats[k] = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                    "share_over": float((d > DIFF_AT).float().mean()),
                    "share_over_batch_diff_at": float((d > BATCH_DIFF_AT).float().mean())}
    return stats


def within_kernel_bounds(stats: dict) -> bool:
    return all(v["max_abs"] <= MAX_DIFF and v["share_over"] <= MAX_DIFF_SHARE for v in stats.values())


def within_batch_bounds(stats: dict) -> bool:
    return all(v["mean_abs"] <= BATCH_MEAN_DIFF and v["share_over_batch_diff_at"] <= BATCH_MAX_SHARE
               for v in stats.values())


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_kind(name: str) -> str:
    return "pcie" if "pcie" in name.lower() else "sxm"


def bound_ms(shape, elem_bytes: int, kind: str, stats: bool = False):
    """Least time for one soft-argmin call: bytes (cost read once, depth written once, and
    with `stats` the (2, B, h, w) fp32 statistics written once, start/interval read once)
    over HBM bandwidth vs operations over the fp32 peak."""
    B, D, h, w = shape
    nbytes = B * D * h * w * elem_bytes + (3 if stats else 1) * B * h * w * 4 + 2 * B * 4
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = B * D * h * w * FLOPS_PER_ELEMENT / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def backward_bound_ms(shape, elem_bytes: int, kind: str):
    """Least time for one backward call: the cost read once and its gradient written once,
    the statistics (2, B, h, w), the depth and incoming gradient maps and start/interval
    read once, over HBM bandwidth, vs BWD_FLOPS_PER_ELEMENT operations per element over
    the fp32 peak."""
    B, D, h, w = shape
    nbytes = 2 * B * D * h * w * elem_bytes + 4 * B * h * w * 4 + 2 * B * 4
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = B * D * h * w * BWD_FLOPS_PER_ELEMENT / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(shape, dtype, seed, peaked=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, D = shape[:2]
    if peaked:
        cost = torch.zeros(shape, device="cuda")
        cost[:, 3] = -60.0
        ds, di = torch.full((B,), 1.0, device="cuda"), torch.full((B,), 0.5, device="cuda")
    else:
        cost = torch.randn(shape, device="cuda", generator=g) * 3.0
        ds = torch.rand(B, device="cuda", generator=g) * 0.7 + 0.3
        di = torch.rand(B, device="cuda", generator=g) * 0.09 + 0.01
    return cost.to(dtype).contiguous(), ds, di


def device_ms(fn, buffers, iters: int) -> float:
    """Device time per call, with CUDA events. A GPU-side sleep keeps the device busy
    while the host enqueues all `iters` calls, so the events bracket device work and
    not the host's launch overhead; inputs cycle through buffers larger than the 50 MB
    L2 so each call reads its volume from HBM, as the main path does."""
    for b in buffers:
        fn(*b)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e7))
    start.record()
    for i in range(iters):
        fn(*buffers[i % len(buffers)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def misaligned_view(cost):
    """The same values as a contiguous tensor whose data_ptr() is one element past a
    16-byte boundary, which the kernel's aligned path cannot take."""
    flat = torch.empty(cost.numel() + 1, device=cost.device, dtype=cost.dtype)
    view = flat[1:].view(cost.shape)
    view.copy_(cost)
    return view


def with_inf_planes(cost, which):
    """Set planes of +inf cost at every 5th pixel: the kernel's first chunk of 8, the upper
    half of D (whole slices on every path: the last 4 of 8 and 8 of 16 on the aligned path,
    the second of 2 on the scalar path), every plane but one, or every plane at pixel (0, 0)
    only (the one case whose depth is NaN)."""
    B, D, h, w = cost.shape
    flat = cost.clone().view(B, D, h * w)
    if which == "first8":
        flat[:, :8, ::5] = torch.inf
    elif which == "slice":
        flat[:, D // 2:, ::5] = torch.inf
    elif which == "all_but_one":
        keep = flat[:, D // 3, ::5].clone()
        flat[:, :, ::5] = torch.inf
        flat[:, D // 3, ::5] = keep
    elif which == "all":
        flat[:, :, 0] = torch.inf
    else:
        raise ValueError(which)
    return flat.view(B, D, h, w)


def kernel_cases():
    """(name, shape, dtype, path expected, transform of the seeded inputs or None)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main native", (1, 128, 120, 224), f32, "aligned", None),
             ("main native bf16", (1, 128, 120, 224), bf16, "aligned", None),
             ("main tile", (1, 128, 120, 896), f32, "aligned", None),
             ("train", TRAIN_SHAPE, f32, "aligned", None),
             ("train bf16", TRAIN_SHAPE, bf16, "aligned", None),
             ("main pair_batch", (2, 128, 120, 224), f32, "aligned", None),
             ("eval native", (1, 128, 128, 160), f32, "aligned", None),
             ("eval native batch 2", (2, 128, 128, 160), f32, "aligned", None),
             ("ragged pixel edge", (2, 16, 8, 4095), f32, "aligned", None),
             ("ragged pixel edge, odd h*w", (2, 16, 7, 4095), f32, "scalar", None),
             ("wide", (1, 128, 8, 4096), f32, "aligned", None),
             ("peaked", (1, 8, 4, 8), f32, "aligned", "peaked"),
             ("odd h*w", (1, 12, 3, 33), f32, "scalar", None),
             ("odd h*w bf16", (1, 32, 5, 7), bf16, "scalar", None),
             ("D=1", (2, 1, 6, 8), f32, "aligned", None),
             ("D=12", (1, 12, 6, 40), f32, "aligned", None),
             ("D=130", (1, 130, 6, 40), f32, "aligned", None),
             ("D=130 bf16", (1, 130, 6, 40), bf16, "aligned", None),
             ("B=3", (3, 48, 10, 12), f32, "aligned", None),
             ("B=3 scalar", (3, 48, 7, 9), f32, "scalar", None),
             ("misaligned pointer", (1, 128, 120, 224), f32, "scalar", "misaligned"),
             ("misaligned pointer bf16", (1, 128, 120, 224), bf16, "scalar", "misaligned")]
    for which in ("first8", "slice", "all_but_one", "all"):
        cases += [(f"+inf {which}", (1, 128, 120, 224), f32, "aligned", which),
                  (f"+inf {which} bf16", (1, 128, 120, 224), bf16, "aligned", which),
                  (f"+inf {which} scalar", (2, 130, 3, 33), f32, "scalar", which)]
    return cases


def phase_kernel() -> float:
    worst = 0.0
    for i, (name, shape, dtype, path, transform) in enumerate(kernel_cases()):
        cost, ds, di = kernel_inputs(shape, dtype, seed=i, peaked=transform == "peaked")
        if transform == "misaligned":
            cost = misaligned_view(cost)
        elif transform not in (None, "peaked"):
            cost = with_inf_planes(cost, transform)
        before = dict(S.softargmin_cuda.path_launches)
        got = S.softargmin_cuda(cost, ds, di)
        with_stats, stats = S.softargmin_cuda(cost, ds, di, with_stats=True)
        ref = S.softargmin_torch(cost, ds, di)
        ref_stats = S.softargmin_partial_torch(cost, ds, di, 0)[:2]
        torch.cuda.synchronize()
        took = [p for p in S.PATHS if S.softargmin_cuda.path_launches[p] == before[p] + 2]
        nan_ref, nan_got = torch.isnan(ref), torch.isnan(got)
        err = torch.where(nan_ref, torch.zeros_like(ref), (got - ref).abs())
        ok = (took == [path] and torch.equal(nan_ref, nan_got)
              and bool((err <= ATOL + RTOL * ref.abs())[~nan_ref].all()))
        # only the all-planes case has NaN, at pixel (0, 0) of every sample, on both sides
        ok = ok and int(nan_ref.sum()) == (shape[0] if transform == "all" else 0)
        if transform == "peaked":
            ok = ok and bool(((got - 2.5).abs() <= 1e-4).all())
        # the statistics: the depth unchanged to the bit, the max to the bit, the sum at RTOL
        same_depth = (torch.equal(torch.isnan(with_stats), nan_got)
                      and torch.equal(with_stats.nan_to_num(), got.nan_to_num()))
        max_exact = torch.equal(stats[0], ref_stats[0])
        sum_ok, sum_err = _within(stats[1], ref_stats[1], RTOL, 0.0)
        ok = ok and same_depth and max_exact and sum_ok
        emit(phase="kernel", case=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
             path=took, nan_pixels=int(nan_got.sum()), max_abs_err=float(err.max()),
             max_rel_err=float((err / ref.abs())[~nan_ref].max()),
             stats={"depth_unchanged": same_depth, "max_exact": max_exact,
                    "sum_max_abs_err": sum_err}, ok=ok)
        if not ok:
            raise AssertionError(f"soft-argmin kernel case '{name}' at {shape}: wrong path, NaN "
                                 "pattern, values or statistics against the plain version")
        worst = max(worst, float(err.max()))
    return worst


def backward_cases():
    """(name, shape, dtype, path expected, transform of the seeded inputs or None). The
    cases named "D % chunk" have a D that the gradient kernel's chunk of planes does not
    divide (checked in phase_kernel_backward)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("train", TRAIN_SHAPE, f32, "aligned", None),
             ("train bf16", TRAIN_SHAPE, bf16, "aligned", None),
             ("D % chunk", (1, 130, 120, 224), f32, "aligned", None),
             ("D % chunk bf16", (1, 130, 120, 224), bf16, "aligned", None),
             ("B=2", (2, 128, 120, 224), f32, "aligned", None),
             ("B=2 train bf16", (2,) + TRAIN_SHAPE[1:], bf16, "aligned", None),
             ("main native", (1, 128, 120, 224), f32, "aligned", None),
             ("main native bf16", (1, 128, 120, 224), bf16, "aligned", None),
             ("main tile", (1, 128, 120, 896), f32, "aligned", None),
             ("odd h*w", (1, 12, 3, 33), f32, "scalar", None),
             ("odd h*w bf16", (1, 32, 5, 7), bf16, "scalar", None),
             ("D=1", (2, 1, 6, 8), f32, "aligned", None),
             ("D=130", (1, 130, 6, 40), f32, "aligned", None),
             ("D=130 bf16", (1, 130, 6, 40), bf16, "aligned", None),
             ("misaligned pointer", (1, 128, 120, 224), f32, "scalar", "misaligned"),
             ("misaligned pointer bf16", (1, 128, 120, 224), bf16, "scalar", "misaligned")]
    for which in ("first8", "slice", "all_but_one", "all"):
        cases += [(f"+inf {which}", (1, 128, 120, 224), f32, "aligned", which),
                  (f"+inf {which} scalar", (2, 130, 3, 33), f32, "scalar", which)]
    return cases


def backward_inputs(shape, dtype, seed, transform=None):
    """The kernel inputs of `kernel_inputs`, the plain forward's statistics and depth, and
    a seeded incoming gradient: the arguments of softargmin_backward_cuda."""
    cost, ds, di = kernel_inputs(shape, dtype, seed)
    if transform == "misaligned":
        cost = misaligned_view(cost)
    elif transform is not None:
        cost = with_inf_planes(cost, transform)
    depth, stats = S.softargmin_torch(cost, ds, di, with_stats=True)
    g = torch.randn(depth.shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    return cost, ds, di, stats, depth, g


def _within(got, want, rtol, atol):
    """NaN at the same elements, and |got - want| <= atol + rtol |want| elsewhere:
    (ok, max abs difference)."""
    nan = torch.isnan(want)
    err = torch.where(nan, torch.zeros_like(want), (got - want).abs())
    ok = torch.equal(torch.isnan(got), nan) and bool((err <= atol + rtol * want.abs())[~nan].all())
    return ok, float(err.max())


def phase_kernel_backward() -> float:
    """The gradient kernel through softargmin_backward_cuda, fed the plain forward's
    statistics, against the closed-form plain backward and against autograd of the plain
    forward, on the same inputs; returns the largest difference to the former."""
    worst = 0.0
    for i, (name, shape, dtype, path, transform) in enumerate(backward_cases()):
        cost, ds, di, stats, depth, g = backward_inputs(shape, dtype, 200 + i, transform)
        grid = S.gradient_grid(shape, dtype, path)
        if name.startswith("D % chunk") and shape[1] % grid[2] == 0:
            raise AssertionError(f"backward case '{name}': chunks of {grid[2]} planes divide D")
        before = dict(S.softargmin_backward_cuda.path_launches)
        got = S.softargmin_backward_cuda(cost, ds, di, stats, depth, g).float()
        ref = S.softargmin_backward_torch(cost, ds, di, depth, g).float()
        leaf = cost.detach().clone().requires_grad_(True)
        S.softargmin_torch(leaf, ds, di).backward(g)
        torch.cuda.synchronize()
        took = [p for p in S.PATHS if S.softargmin_backward_cuda.path_launches[p] == before[p] + 1]
        scale = float(ref.nan_to_num(0.0).abs().max())
        plain_ok, err = _within(got, ref, BWD_RTOL[dtype], 1e-6 * scale)
        auto_atol = 1e-5 * float(g.abs().max()) * float(S.sweep(shape[1], ds, di).abs().max())
        auto_ok, err_auto = _within(got, leaf.grad.float(), BWD_RTOL[dtype], auto_atol)
        # only the all-planes case has NaN: every plane of pixel (0, 0) of every sample
        nan = int(torch.isnan(got).sum())
        ok = (took == [path] and plain_ok and auto_ok
              and nan == (shape[0] * shape[1] if transform == "all" else 0))
        emit(phase="kernel", direction="backward", case=name, shape=list(shape),
             dtype=str(dtype).split(".")[-1], path=took, grid=list(grid), nan_elements=nan,
             max_abs_err=err,
             max_abs_err_vs_autograd=err_auto, gradient_scale=scale, ok=ok)
        if not ok:
            raise AssertionError(f"soft-argmin backward case '{name}' at {shape}: wrong path, NaN "
                                 "pattern or values against the plain backward or autograd")
        worst = max(worst, err)
    return worst


def phase_small():
    """Trained weights at a small size: GPU (kernel, cuDNN) vs CPU (plain, oneDNN)."""
    cfg = PipelineConfig(view_num=3, max_d=32, max_h=64, max_w=96)
    scene = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = load_model(SPHERES, cfg, device=dev)
        outs[dev] = {k: v.float().cpu().numpy() for k, v in
                     multi_view_forward(model, scene["images"], scene["cams"], cfg).items()}
    interval = 0.5 / 32
    record = {}
    for key in ("depth", "depth_up", "depth_agg_initial"):
        record[key] = float(np.abs(outs["cuda"][key] - outs["cpu"][key]).max())
    mae = float(np.abs(outs["cuda"]["depth"] - scene["depth_gt"]).mean())
    ok = max(record.values()) <= SMALL_MAX_DIFF and mae < 2 * interval
    emit(phase="small", max_abs_diff_gpu_vs_cpu=record, mae_vs_gt=mae, interval=interval, ok=ok)
    if not ok:
        raise AssertionError("small trained forward: GPU and CPU disagree or the scene is lost")


def phase_forward(model, images, cams, cfg):
    torch.backends.cudnn.deterministic = True
    S.reset_launch_counts()
    C2.reset_launch_counts()
    C3.reset_launch_counts()
    CT.reset_launch_counts()
    PS.reset_launch_counts()
    out = multi_view_forward(model, images, cams, cfg)
    torch.cuda.synchronize()
    conv2d_launches = C2.conv2d_fp32_cuda.launches
    conv3d_launches = C3.conv3d_fp32_cuda.launches
    deconv3d_launches = CT.conv3d_transpose_fp32_cuda.launches
    deconv3d_paths = dict(CT.conv3d_transpose_fp32_cuda.path_launches)
    sweep_launches = PS.plane_sweep_cuda.launches
    sweep_paths = {k: v for k, v in PS.plane_sweep_cuda.path_launches.items() if v}
    launches = S.softargmin_cuda.launches
    by_path = dict(S.softargmin_cuda.path_launches)
    by_shape = dict(S.softargmin_cuda.shape_launches)
    B, N, H, W = 1, cfg.view_num, cfg.max_h, cfg.max_w
    h, w, D, P = H // 4, W // 4, cfg.max_d, N - 1
    shapes = {"depth": (B, h, w, 1), "depth_up": (B, H, W, 1), "depth_agg_initial": (B, h, w, 1),
              "prob_volume_agg": (B, D, h, w), "prob_volumes": (P, B, D, h, w),
              "refined_prob_volumes": (P, B, D, h, w), "depth_views": (P, B, h, w, 1)}
    bad = [k for k, s in shapes.items() if tuple(out[k].shape) != s]
    nonfinite = [k for k in shapes if not bool(torch.isfinite(out[k]).all())]

    S.reset_launch_counts()
    plain = multi_view_forward(model, images, cams, cfg.replace(softargmin_impl="torch"))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    if S.softargmin_cuda.launches != 0:
        raise AssertionError("softargmin_impl='torch' launched the kernel")
    agree = depth_differences(out, plain, DEPTH_KEYS)
    agree_ok = within_kernel_bounds(agree)
    depth = out["depth"]
    del plain
    # "default" keeps pass_conv_transpose (cuDNN's TF32 dgrad): no launch of the kernel
    CT.reset_launch_counts()
    with torch.no_grad():
        multi_view_forward(model, images, cams, cfg.replace(fp32_precision="default"))
    torch.cuda.synchronize()
    deconv3d_default_launches = CT.conv3d_transpose_fp32_cuda.launches
    deconv3d_ok = (deconv3d_launches == deconv3d_forward_launches(cfg.view_num)
                   and deconv3d_paths["scalar"] == 0 and deconv3d_default_launches == 0)
    emit(phase="forward", launches=launches, expected_launches=EXPECTED_LAUNCHES,
         conv2d_launches=conv2d_launches,
         conv2d_expected_launches=conv2d_forward_launches(cfg.view_num),
         conv3d_launches=conv3d_launches,
         conv3d_expected_launches=conv3d_forward_launches(cfg.view_num),
         deconv3d_launches=deconv3d_launches, deconv3d_launches_by_path=deconv3d_paths,
         deconv3d_expected_launches=deconv3d_forward_launches(cfg.view_num),
         deconv3d_default_launches=deconv3d_default_launches,
         sweep_launches=sweep_launches,
         sweep_expected_launches=sweep_forward_launches(cfg.view_num),
         sweep_launches_by_path=sweep_paths,
         launches_by_path=by_path, launches_by_shape=shape_counts(by_shape), bad_shapes=bad, nonfinite=nonfinite, depth_mean=float(depth.mean()),
         depth_min=float(depth.min()), depth_max=float(depth.max()),
         kernel_vs_plain=agree, diff_at=DIFF_AT, max_share=MAX_DIFF_SHARE, max_diff=MAX_DIFF,
         ok=(not bad and not nonfinite and by_shape == MAIN_SHAPES
             and by_path["aligned"] == launches and agree_ok and deconv3d_ok))
    if bad or nonfinite:
        raise AssertionError(f"forward outputs wrong: shapes {bad}, non-finite {nonfinite}")
    if by_shape != MAIN_SHAPES:
        raise AssertionError(f"soft-argmin kernel launches {by_shape}, expected {MAIN_SHAPES}")
    if conv2d_launches != conv2d_forward_launches(cfg.view_num):
        raise AssertionError(f"fp32 conv2d kernel launches {conv2d_launches}, expected "
                             f"{conv2d_forward_launches(cfg.view_num)}")
    if conv3d_launches != conv3d_forward_launches(cfg.view_num):
        raise AssertionError(f"fp32 conv3d kernel launches {conv3d_launches}, expected "
                             f"{conv3d_forward_launches(cfg.view_num)}")
    if not deconv3d_ok:
        raise AssertionError(f"fp32 transposed conv3d kernel launches {deconv3d_launches} by "
                             f"path {deconv3d_paths}, {deconv3d_default_launches} under "
                             f"default; expected {deconv3d_forward_launches(cfg.view_num)} on "
                             f"the vector path, 0 under default")
    if by_path["aligned"] != launches:
        raise AssertionError(f"the main path left the kernel's aligned path: {by_path}")
    if sweep_launches != sweep_forward_launches(cfg.view_num) or sweep_paths != SWEEP_FORWARD_PATHS:
        raise AssertionError(f"plane-sweep kernel launches {sweep_launches} by path {sweep_paths}, "
                             f"expected {sweep_forward_launches(cfg.view_num)} by path "
                             f"{SWEEP_FORWARD_PATHS}")
    if not agree_ok:
        raise AssertionError(f"kernel and plain forwards disagree: {agree}")
    return launches


def phase_timing(model, images, cams, cfg, kind, iters=5):
    # default cuDNN algorithms (the main path), then the deterministic ones for comparison
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        multi_view_forward(model, images, cams, cfg)      # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            multi_view_forward(model, images, cams, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sec = float(np.median(times))
        emit(phase="timing", what="forward", cudnn_deterministic=deterministic,
             view_num=cfg.view_num, size=[cfg.max_h, cfg.max_w], max_d=cfg.max_d,
             dtype=cfg.compute_dtype, seconds_each=times, seconds_median=sec,
             maps_per_s=1.0 / sec, peak_memory_bytes=torch.cuda.max_memory_allocated())
    torch.backends.cudnn.deterministic = False
    phase_activation(model, images, cams, cfg)
    return phase_timing_kernel(kind)


def phase_timing_kernel(kind):
    """Device times of the forward kernel beside the plain version's, the HBM bound and an
    empty launch of the same grid: the flagship forward's two calls, the pair_batch
    forward's stacked one and the eval path's call (8 views at 512x640), then what no
    forward here runs: bf16, and the scalar path at the native shape (through a pointer
    that is not 16-byte aligned). With the statistics that autograd asks for ("stats":
    true, 8 bytes per pixel more in the bound) at the flagship's fp32 shapes and the train
    CLI's bf16 shape, each beside its line without. Returns the kernel, plain and bound ms
    of one flagship forward (MAIN_SHAPES) and what bounds them."""
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = "bytes"
    f32, bf16 = torch.float32, torch.bfloat16
    for shape, dtype, path, stats in [
            ((1, 128, 120, 224), f32, "aligned", False), ((1, 128, 120, 224), f32, "aligned", True),
            ((1, 128, 120, 896), f32, "aligned", False), ((1, 128, 120, 896), f32, "aligned", True),
            ((2, 128, 120, 224), f32, "aligned", False), ((1, 128, 128, 160), f32, "aligned", False),
            ((1, 128, 120, 224), bf16, "aligned", False),
            (TRAIN_SHAPE, bf16, "aligned", False), (TRAIN_SHAPE, bf16, "aligned", True),
            ((1, 128, 120, 224), f32, "scalar", False), ((1, 128, 120, 224), bf16, "scalar", False)]:
        elem = torch.tensor([], dtype=dtype).element_size()
        nbuf = max(2, math.ceil(200e6 / (math.prod(shape) * elem)))
        bufs = [kernel_inputs(shape, dtype, seed=100 + i) for i in range(nbuf)]
        if path == "scalar":
            bufs = [(misaligned_view(c), ds, di) for c, ds, di in bufs]
        if {S.kernel_path(c.data_ptr(), shape[2] * shape[3], dtype) for c, _, _ in bufs} != {path}:
            raise AssertionError(f"timing buffers at {shape} are not all on the {path} path")
        k_ms = device_ms(lambda c, ds, di: S.softargmin_cuda(c, ds, di, with_stats=stats), bufs, 50)
        p_ms = device_ms(lambda c, ds, di: S.softargmin_torch(c, ds, di, with_stats=stats), bufs, 20)
        e_ms = device_ms(lambda c, ds, di: S.empty_launch(c), bufs, 50)
        b_ms, b_by = bound_ms(shape, elem, kind, stats)
        emit(phase="timing", what="softargmin", shape=list(shape), dtype=str(dtype).split(".")[-1],
             path=path, stats=stats, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
             empty_launch_ms=e_ms, kernel_over_bound=k_ms / b_ms,
             kernel_gb_per_s=(math.prod(shape) * elem) / (k_ms * 1e-3) / 1e9,
             library_ms=None, library="none: no single PyTorch call computes soft-argmin")
        del bufs
        if dtype == f32 and path == "aligned" and not stats and shape in MAIN_SHAPES:
            n = MAIN_SHAPES[shape]
            totals["ms"] += n * k_ms
            totals["plain_ms"] += n * p_ms
            totals["bound_ms"] += n * b_ms
            bound_by = b_by if b_by == "operations" else bound_by
    return totals, bound_by


def phase_activation(model, images, cams, cfg):
    """Seconds of the flagship forward with the port's activation, torch.maximum(y, 0)
    (L.activate), against the same forward with torch.relu in its place: the same values,
    another gradient at a tie. Timed in turns (ACTIVATION_ORDER) after one warm forward of
    each; the module's activation is put back whatever happens."""
    port_activate = L.activate
    seconds = {"relu": [], "maximum": []}
    try:
        for name in ("relu", "maximum") + ACTIVATION_ORDER:
            L.activate = torch.relu if name == "relu" else port_activate
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            multi_view_forward(model, images, cams, cfg)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
    finally:
        L.activate = port_activate
    relu, maximum = seconds["relu"][1:], seconds["maximum"][1:]   # the warm ones dropped
    emit(phase="timing", what="activation", order=list(ACTIVATION_ORDER),
         relu_seconds=relu, maximum_seconds=maximum,
         relu_median=float(np.median(relu)), maximum_median=float(np.median(maximum)),
         maximum_over_relu=float(np.median(maximum) / np.median(relu)))


def phase_timing_backward(kind):
    """Device times of the gradient kernel through softargmin_backward_cuda beside the
    closed-form plain backward's, its bound and an empty launch of its grid: at the train
    shape (the CLI's bf16 and fp32), the flagship's shapes, and the scalar path at the
    native shape. Returns the kernel, plain and bound milliseconds of one CLI train step
    (its launches at the train shape, bf16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    per_step = TRAIN_LAUNCHES[(False, 0.0)][1]
    totals, bound_by = {}, "bytes"
    for shape, dtype, path in [(TRAIN_SHAPE, bf16, "aligned"), (TRAIN_SHAPE, f32, "aligned"),
                               ((1, 128, 120, 224), f32, "aligned"), ((1, 128, 120, 896), f32, "aligned"),
                               ((1, 128, 120, 224), bf16, "aligned"), ((1, 128, 120, 224), f32, "scalar")]:
        elem = torch.tensor([], dtype=dtype).element_size()
        nbuf = max(2, math.ceil(200e6 / (math.prod(shape) * elem)))
        bufs = [backward_inputs(shape, dtype, 300 + i, "misaligned" if path == "scalar" else None)
                for i in range(nbuf)]
        if {S.kernel_path(b[0].data_ptr(), shape[2] * shape[3], dtype) for b in bufs} != {path}:
            raise AssertionError(f"backward timing buffers at {shape} are not all on the {path} path")
        k_ms = device_ms(S.softargmin_backward_cuda, bufs, 50)
        p_ms = device_ms(lambda c, ds, di, _, d, g: S.softargmin_backward_torch(c, ds, di, d, g),
                         bufs, 20)
        # what the card reaches on the same bytes: a device copy of the cost (read once,
        # written once), beside the kernel and its bound
        copy_ms = device_ms(lambda c, *_: torch.empty_like(c).copy_(c), bufs, 50)
        e_ms = device_ms(lambda c, *_: S.empty_launch(c, grid="gradient"), bufs, 50)
        b_ms, b_by = backward_bound_ms(shape, elem, kind)
        emit(phase="timing", what="softargmin_backward", shape=list(shape),
             dtype=str(dtype).split(".")[-1], path=path,
             grid=list(S.gradient_grid(shape, dtype, path)), kernel_ms=k_ms, plain_ms=p_ms,
             copy_ms=copy_ms,
             bound_ms=b_ms, bound_by=b_by, empty_launch_ms=e_ms, kernel_over_bound=k_ms / b_ms,
             kernel_gb_per_s=2 * math.prod(shape) * elem / (k_ms * 1e-3) / 1e9, buffers=nbuf,
             library_ms=None, library="none: no single PyTorch call computes this gradient")
        del bufs
        if shape == TRAIN_SHAPE and dtype == bf16:
            totals = {"ms": per_step * k_ms, "plain_ms": per_step * p_ms, "bound_ms": per_step * b_ms}
            bound_by = b_by
    return totals, bound_by


def phase_profile(model, images, cams, cfg):
    """Device time of one forward (at cfg's act_quant) by kind of work, from
    torch.profiler's kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    multi_view_forward(model, images, cams, cfg)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        multi_view_forward(model, images, cams, cfg)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    event_ms = start.elapsed_time(end)
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    pseudo = ("Buffer Flush", "Activity Buffer Request")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in pseudo]
    categories = {"int8 conv (this repo's CUDA kernel)": ("conv3d_int8",),
                  "fp32 conv2d (this repo's CUDA kernel)": ("conv2d_fp32",),
                  "fp32 conv3d (this repo's CUDA kernel)": ("conv3d_fp32",),
                  "fp32 transposed conv3d (this repo's CUDA kernel)": ("conv3d_transpose",),
                  "cuDNN conv + cuBLAS gemm (incl. FFT conv)": ("conv", "xmma", "gemm", "fft",
                                                             "Tensor5d", "nchw", "nhwc", "DSE::",
                                                             "region_transform"),
                  "softargmin (this repo's CUDA kernel)": ("softargmin",),
                  "plane-sweep sampler (this repo's CUDA kernel)": ("plane_sweep_gather",),
                  "gather (the confidence's, the fusion's)": ("gather", "index"),
                  "elementwise/reduce (BN, masks, AAM)": ("elementwise", "reduce", "Memcpy",
                                                          "Memset", "pool", "cat")}
    split = {c: 0.0 for c in categories}
    split["other"] = 0.0
    for e in kernels:
        cat = next((c for c, keys in categories.items()
                    if any(k.lower() in e.key.lower() for k in keys)), "other")
        split[cat] += getattr(e, attr) / 1e3
    busy = sum(split.values())
    top = sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:15]
    # Idle share against the device's own clock between the two events. The profiler's
    # summed kernel time can exceed that span (it did, against the host's wall time); the
    # share is then reported as it is, negative, and not cut to 0.
    emit(phase="profile", act_quant=cfg.act_quant, wall_ms=wall * 1e3, event_ms=event_ms,
         device_busy_ms=busy,
         device_idle_share=1.0 - busy / event_ms, device_ms_by_kind=split,
         top_kernels=[{"name": e.key[:90], "device_ms": getattr(e, attr) / 1e3, "calls": e.count}
                      for e in top])


def timed_forward(model, images, cams, cfg, **kw):
    """One forward bracketed by synchronize(): (outputs, seconds, peak bytes, launches by shape)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launch_counts()
    t0 = time.perf_counter()
    out = multi_view_forward(model, images, cams, cfg, **kw)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            dict(S.softargmin_cuda.shape_launches))


def stage_breakdown(model, images, cams, cfg) -> tuple[dict, dict]:
    """The forward stage by stage (models.tvsnet's functions, as multi_view_forward calls
    them), with stage 1 and stage 3 both per pair and batched on the SAME inputs.

    Returns ({stage: {"seconds", "peak_bytes"}} of the second of two rounds, and
    {stage: {"max_abs", "scale"}} of batched against per-pair outputs).
    """
    images, cams = prepare_inputs(model, images, cams, cfg)
    start, interval = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    batched_cfg = cfg.replace(pair_batch=True)
    pairs = range(1, cfg.view_num)
    stages, diffs = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = {"seconds": time.perf_counter() - t0,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
        return out

    def diff(name, got, want):
        diffs[name] = {"max_abs": float((got - want).abs().max()), "scale": float(want.abs().max())}

    def base(c):
        return [tvsnet_base(model, feats[:, 0], feats[:, v], cams[:, 0], cams[:, v], c,
                            start, interval) for v in pairs]

    for _ in range(2):
        feats = run("fem", lambda: extract_features(model, images, cfg))
        shallow = run("fem_shallow", lambda: extract_features(model, images, cfg, shallow=True))
        outs = run("stage1_per_pair", lambda: base(cfg))
        outs_b = run("stage1_pair_batch", lambda: base(batched_cfg))
        for field in ("prob_volume", "filtered_cost"):
            diff("stage1_" + field, torch.stack([getattr(o, field) for o in outs_b]),
                 torch.stack([getattr(o, field) for o in outs]))
        del outs_b
        costs = torch.stack([o.filtered_cost for o in outs])
        views = torch.stack([o.depth_view for o in outs])
        del outs
        cost_agg = run("aam1", lambda: aam_aggregate_stacked(model, costs, stage=1))
        del costs
        prob_agg = aam_output_conv(model, cost_agg, stage=1)
        depth_agg = prob2depth(prob_agg, cfg.max_d, start, interval)
        loop = run("stage3_per_pair", lambda: [
            refinement(model, depth_agg, views[v - 1], cams[:, 0], cams[:, v], shallow[:, 0],
                       shallow[:, v], prob_agg, cfg, start, interval) for v in pairs])
        batched = run("stage3_pair_batch", lambda: refine_pairs_batched(
            model, depth_agg, views, prob_agg, cams, shallow, cfg, start, interval))
        for i, field in enumerate(("cost_residual", "prob_residual")):
            diff("stage3_" + field, batched[i], torch.stack([one[i] for one in loop]))
        refined = cost_agg[None] + batched[0]
        del loop, batched
        cost_agg2 = run("aam2", lambda: aam_aggregate_stacked(model, refined, stage=2))
        del refined
        prob_agg2 = aam_output_conv(model, cost_agg2, stage=2)
        run("upsampled_softargmin", lambda: prob2depth_upsample(prob_agg2, cfg.max_d, start, interval))
        del cost_agg, cost_agg2, prob_agg, prob_agg2, feats, shallow
    return stages, diffs


def phase_pair_batch(model, images, cams, cfg):
    """pair_batch=True against False: depths (deterministic cuDNN; see BATCH_MEAN_DIFF),
    launches per shape, seconds in turns (False, True, True, False) with both kinds of
    cuDNN algorithm, and the stage-by-stage breakdown with stages 1 and 3 batched against
    per pair on the same inputs."""
    cfgs = {False: cfg, True: cfg.replace(pair_batch=True)}
    expected = {False: MAIN_SHAPES, True: PAIR_BATCH_SHAPES}
    depths, record = {}, {}
    for deterministic in (True, False):
        torch.backends.cudnn.deterministic = deterministic
        for pb in (False, True):
            multi_view_forward(model, images, cams, cfgs[pb])      # warm
        seconds, peak = {False: [], True: []}, {False: 0, True: 0}
        for pb in (False, True, True, False):
            out, sec, nbytes, by_shape = timed_forward(model, images, cams, cfgs[pb])
            if by_shape != expected[pb]:
                raise AssertionError(f"pair_batch={pb}: launches {by_shape}, expected {expected[pb]}")
            seconds[pb].append(sec)
            peak[pb] = max(peak[pb], nbytes)
            if deterministic:
                depths[pb] = {k: out[k] for k in DEPTH_KEYS}
            del out
        record["deterministic" if deterministic else "default"] = {
            "seconds_sequential": seconds[False], "seconds_pair_batch": seconds[True],
            "peak_bytes_sequential": peak[False], "peak_bytes_pair_batch": peak[True]}
    before = depth_differences(depths[True], depths[False], ("depth_views", "depth_agg_initial"))
    final = depth_differences(depths[True], depths[False], ("depth", "depth_up"))
    torch.backends.cudnn.deterministic = True
    stages, same_inputs = stage_breakdown(model, images, cams, cfg)
    torch.backends.cudnn.deterministic = False
    stages_ok = all(v["max_abs"] <= STAGE_REL_DIFF * v["scale"] for v in same_inputs.values())
    ok = within_kernel_bounds(before) and within_batch_bounds(final) and stages_ok
    emit(phase="pair_batch", launches_pair_batch=shape_counts(PAIR_BATCH_SHAPES),
         launches_sequential=shape_counts(MAIN_SHAPES), before_refinement=before,
         diff_at=DIFF_AT, max_share=MAX_DIFF_SHARE, max_diff=MAX_DIFF,
         batched_vs_per_pair_same_inputs=same_inputs, stage_rel_diff=STAGE_REL_DIFF,
         stages_deterministic=stages, final_depths=final,
         batch_mean_diff=BATCH_MEAN_DIFF, batch_diff_at=BATCH_DIFF_AT,
         batch_max_share=BATCH_MAX_SHARE, peak_bytes_reckoned=PAIR_BATCH_PEAK_RECKONED,
         **record, ok=ok)
    if not ok:
        raise AssertionError("pair_batch=True and False disagree; see the line above")


def serving_request(seed: int, cfg: PipelineConfig, size=None):
    """uint8 frames and request cams (full-resolution intrinsics, metric depth row) whose
    preparation gives synthetic_scene(seed)'s cost-volume cams and sweep back; `size`
    crops the frames to (h, w)."""
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=seed)
    frames = [np.uint8(im * 255.0) for im in images[0]]
    if size is not None:
        frames = [f[:size[0], :size[1]] for f in frames]
    request_cams = []
    for cam in cams[0]:
        cam = scale_camera_np(cam, 1.0 / cfg.sample_scale)
        start, interval = cam[1, 3, 0], cam[1, 3, 1]
        cam[1, 3] = (1.0 / (start + interval * cfg.max_d), 0.0, cfg.max_d, 1.0 / start)
        request_cams.append(cam)
    return frames, request_cams


def confidence_agreement(got, ref, depth_index, margin=1e-3):
    """Max confidence difference where the depth index is at least `margin` away from an
    integer (probability_map is discontinuous at integer bin indices)."""
    away = np.abs(depth_index - np.round(depth_index)) > margin
    return float(np.abs(got - ref)[away].max()), float(away.mean())


def phase_serving(cfg):
    est = DepthEstimator(cfg, params_path=SPHERES)
    warmup_s = est.warmup()
    frames, cams = serving_request(0, cfg)
    H, W, h, w = cfg.max_h, cfg.max_w, cfg.max_h // 4, cfg.max_w // 4

    # one request, against the bare forward on the same prepared inputs
    torch.backends.cudnn.deterministic = True
    S.reset_launch_counts()
    out = est.predict(frames, cams)
    by_shape = dict(S.softargmin_cuda.shape_launches)
    shapes = {"depth": (h, w), "depth_up": (H, W), "confidence": (h, w), "confidence_up": (H, W)}
    bad = [k for k, s in shapes.items() if out[k].shape != s or out[k].dtype != np.float32]
    nonfinite = [k for k in shapes if not np.isfinite(out[k]).all()]
    batch = prepare_mvs_sample(frames, cams, cfg.view_num, max_d=cfg.max_d, max_h=H, max_w=W,
                               sample_scale=cfg.sample_scale, inverse_depth=cfg.inverse_depth,
                               center=False)
    x = center_images(torch.from_numpy(batch["images"]).cuda())
    ref = multi_view_forward(est.model, x, batch["cams"], cfg, out_prob_map=True)
    start, interval = float(batch["cams"][0, 0, 1, 3, 0]), float(batch["cams"][0, 0, 1, 3, 1])
    vs_forward = {}
    for key in ("depth", "depth_up"):
        want = sweep_to_depth(ref[key], cfg.inverse_depth)[0, ..., 0].cpu().numpy()
        vs_forward[key] = float(np.abs(out[key] - want).max())
        sweep_index = (ref[key][0, ..., 0].cpu().numpy() - start) / interval
        conf_key = "confidence" + key[len("depth"):]
        vs_forward[conf_key], vs_forward[conf_key + "_share_compared"] = confidence_agreement(
            out[conf_key], ref[conf_key][0, ..., 0].cpu().numpy(), sweep_index)
    del ref, x
    forward_ok = (max(vs_forward["depth"], vs_forward["depth_up"]) <= SERVING_MAX_DIFF
                  and max(vs_forward["confidence"], vs_forward["confidence_up"]) <= SERVING_MAX_DIFF)

    # predict_many of 2 requests against 2 predict calls (deterministic cuDNN)
    requests = [(frames, cams), serving_request(1, cfg)]
    many = est.predict_many(requests)
    singles = [out, est.predict(*requests[1])]
    many_agree = [depth_differences(m, s, ("depth", "depth_up")) for m, s in zip(many, singles)]
    torch.backends.cudnn.deterministic = False

    # a second bucket serves a smaller request: routed to it, padded, cropped back
    est.add_bucket(max_h=256, max_w=320)
    small = est.predict(*serving_request(2, cfg, size=(250, 300)))
    small_shapes = {k: list(small[k].shape) for k in shapes}
    small_ok = (small["bucket"] == (256, 320) and out["bucket"] == (H, W)
                and small_shapes == {"depth": [62, 75], "depth_up": [250, 300],
                                     "confidence": [62, 75], "confidence_up": [250, 300]}
                and all(np.isfinite(small[k]).all() for k in shapes))

    # a preprocessed request must be of a bucket's exact size
    try:
        est.predict([f[:128, :160].astype(np.float32) for f in frames], cams, preprocessed=True)
        raised = False
    except ValueError:
        raised = True

    # steady requests on the flagship bucket, cuDNN's default algorithms, in turns with the
    # bare forward (out_prob_map=True) on the same prepared inputs already on the card
    x = center_images(torch.from_numpy(batch["images"]).cuda())
    device_cams = torch.from_numpy(batch["cams"]).cuda()
    est.predict(frames, cams)
    multi_view_forward(est.model, x, device_cams, cfg, out_prob_map=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtimes, walls, forwards = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        runtimes.append(est.predict(frames, cams)["runtime_s"])
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        multi_view_forward(est.model, x, device_cams, cfg, out_prob_map=True)
        torch.cuda.synchronize()
        forwards.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    host_ms = [(wall - run) * 1e3 for wall, run in zip(walls, runtimes)]

    ok = (not bad and not nonfinite and by_shape == PROB_MAP_SHAPES and forward_ok
          and all(map(within_batch_bounds, many_agree)) and small_ok and raised)
    emit(phase="serving", warmup_seconds=warmup_s, launches_by_shape=shape_counts(by_shape),
         expected_launches=shape_counts(PROB_MAP_SHAPES), bad_shapes=bad, nonfinite=nonfinite,
         predict_vs_forward_max_abs=vs_forward, max_diff_vs_forward=SERVING_MAX_DIFF,
         predict_many_vs_predict=many_agree, diff_at=DIFF_AT,
         batch_mean_diff=BATCH_MEAN_DIFF, batch_diff_at=BATCH_DIFF_AT,
         batch_max_share=BATCH_MAX_SHARE, second_bucket={"bucket": list(small["bucket"]), "shapes": small_shapes},
         off_bucket_preprocessed_raises=raised, runtime_s_each=runtimes,
         runtime_s_median=float(np.median(runtimes)), bare_forward_s_each=forwards,
         bare_forward_s_median=float(np.median(forwards)),
         host_ms_outside_runtime_median=float(np.median(host_ms)),
         peak_memory_bytes=peak, depth_mean=float(out["depth"].mean()), ok=ok)
    if not ok:
        raise AssertionError("serving phase failed; see the line above")


def phase_example(cfg):
    """The example CLI's run_example on a rendered example/0 directory in a temp dir."""
    with tempfile.TemporaryDirectory() as root:
        scene = render_multiplane_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                        D=cfg.max_d, seed=21, num_spheres=3)
        write_example_dir(os.path.join(root, "0"), scene)
        out_dir = os.path.join(root, "out")
        result = run_example(root, 0, cfg.view_num, params_path=SPHERES, savepath=out_dir,
                             max_d=cfg.max_d)
        files = sorted(os.listdir(out_dir))
        pred = np.load(os.path.join(out_dir, "pred.npy"))
        with open(os.path.join(out_dir, "error.json")) as f:
            errors = json.load(f)
    finite = bool(np.isfinite(pred).all()) and all(math.isfinite(v) for v in errors.values())
    ok = (files == ["error.json", "error.xlsx", "pred.jpg", "pred.npy"] and finite
          and pred.shape == (cfg.max_h, cfg.max_w) and errors == result["errors"])
    emit(phase="example", codec="cv2", files=files, pred_shape=list(pred.shape),
         first_call_s=result["first_call_s"], second_call_s=result["runtime_s"],
         errors=errors, ok=ok)
    if not ok:
        raise AssertionError("example phase failed; see the line above")


def phase_native():
    """Build the host library from the repository's source, require that it loaded, and
    hold each function against its numpy version at a scene's size."""
    t0 = time.perf_counter()
    native.build(force=True)
    lib = native.require_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    H, W = 480, 896
    packed = np.zeros((H, W, 4), np.uint8)
    packed[..., 0] = rng.rand(H, W) > 0.4
    packed[..., 1:] = rng.randint(0, 256, (H, W, 3))
    depth = (1.0 + rng.rand(H, W)).astype(np.float32)
    K = np.array([[float(W), 0, W / 2], [0, float(W), H / 2], [0, 0, 1.0]])
    P = K @ np.hstack([np.eye(3), np.array([[0.1], [-0.2], [0.3]])])
    Minv, P4 = np.linalg.inv(P[:, :3]), P[:, 3]
    mask = packed[..., 0].astype(bool)
    points = rng.randn(H, W, 3).astype(np.float32)
    colours = (rng.rand(H, W, 3) * 300 - 20).astype(np.float32)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, (time.perf_counter() - t0) * 1e3

    (bp, bp_ms), (bp_ref, bp_np_ms) = (timed(native.compact_backproject, packed, depth, Minv, P4),
                                       timed(native.compact_backproject_numpy, packed, depth, Minv, P4))
    (cp, cp_ms), (cp_ref, cp_np_ms) = (timed(native.compact_points, mask, points, colours),
                                       timed(native.compact_points_numpy, mask, points, colours))
    with tempfile.TemporaryDirectory() as tmp:
        _, ply_ms = timed(native.write_ply, os.path.join(tmp, "a.ply"), bp[0], bp[1])
        _, ply_np_ms = timed(native.write_ply_numpy, os.path.join(tmp, "b.ply"), bp[0], bp[1])
        with open(os.path.join(tmp, "a.ply"), "rb") as a, open(os.path.join(tmp, "b.ply"), "rb") as b:
            ply_equal = a.read() == b.read()
        # OpenCV decodes EXR only where its build has the codec: a map it can write must read back
        exr = os.path.join(tmp, "depth.exr")
        import cv2
        try:
            exr_written = bool(cv2.imwrite(exr, depth[:32, :48]))
        except cv2.error:
            exr_written = False
        exr_ok = (not exr_written) or np.array_equal(image_io.imread_depth(exr), depth[:32, :48])
    # float64 products rounded to float32: the compiler may contract a*b+c, so 1 ulp
    backproject_err = float(np.abs(bp[0] - bp_ref[0]).max())
    ok = (lib is native.get_lib() and os.path.exists(native.LIBRARY)
          and native.count_mask(mask) == int(mask.sum())
          and bp[0].shape == bp_ref[0].shape and np.array_equal(bp[1], bp_ref[1])
          and np.allclose(bp[0], bp_ref[0], rtol=2e-7, atol=1e-7)
          and np.array_equal(cp[0], cp_ref[0]) and np.array_equal(cp[1], cp_ref[1])
          and ply_equal and exr_ok)
    emit(phase="native", build_seconds=build_s, library=os.path.relpath(native.LIBRARY, ROOT),
         source=os.path.relpath(native.SOURCE, ROOT), pixels=H * W, points=int(mask.sum()),
         compact_backproject_ms=bp_ms, compact_backproject_numpy_ms=bp_np_ms,
         compact_backproject_max_abs_err=backproject_err,
         compact_points_ms=cp_ms, compact_points_numpy_ms=cp_np_ms,
         write_ply_ms=ply_ms, write_ply_numpy_ms=ply_np_ms, ply_equal=ply_equal,
         exr_codec=exr_written, exr_roundtrip_ok=exr_ok, ok=ok)
    if not ok:
        raise AssertionError("native phase failed; see the line above")


def fusion_scene(n_views, H, W, seed):
    """Rendered views with their true depths: depths (V, H, W), uint8 images (V, H, W, 3),
    cams (V, 2, 4, 4) with full-resolution intrinsics."""
    r = render_multiplane_views(n_views, H, W, seed=seed, spacing=0.05, rot_step=0.02,
                                num_spheres=3)
    cams = np.stack([make_cam(r["K_full"], r["Rs"][v], r["ts"][v], 1.0, 1.0 / 128, 128)
                     for v in range(n_views)])
    return r["depths"].astype(np.float32), np.uint8(r["images"] * 255.0), cams


def with_holes(depths, share, seed):
    """`share` of the pixels zeroed (filtered), drawn from `seed`."""
    holes = np.random.RandomState(seed).rand(*depths.shape) < share
    return np.where(holes, 0.0, depths).astype(np.float32)


def cloud_agreement(a, b):
    """Two (points, colours) clouds of the same scene: the share of points that only one
    has (matched by the bits of xyz: both come from the host's float64 back-projection of
    the same pixel) and the largest colour difference among the matched."""
    def keys(points):
        return np.ascontiguousarray(points).view([("", points.dtype)] * 3).reshape(-1)
    _, ia, ib = np.intersect1d(keys(a[0]), keys(b[0]), return_indices=True)
    larger = max(len(a[0]), len(b[0]), 1)
    unmatched = len(a[0]) + len(b[0]) - 2 * len(ia)
    colour = np.abs(a[1][ia].astype(np.int32) - b[1][ib].astype(np.int32)).max(initial=0)
    return unmatched / larger, int(colour)


def fusion_bound_ms(V, H, W, ref_chunk, kind):
    """Least time for the consistency check of one scene, every view as reference once:
    each chunk reads the depth maps (4 B/px), the uint8 images (3 B/px) and the cameras once
    and writes 4 B per reference pixel; V - 1 checks per reference pixel."""
    chunks = -(-V // ref_chunk)
    nbytes = chunks * (V * H * W * 7 + V * 112) + V * H * W * 4
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = V * (V - 1) * H * W * FUSION_FLOP_PER_CHECK / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fusion_device_ms(depths, images, cams, ref_chunk, sparse):
    """Device time of the consistency check alone for one scene (CUDA events around the
    chunks, inputs resident, nothing downloaded; the sparse path with its lists made and
    its rows scattered back on the device, as fuse_depth_maps runs it), and of downloading
    its packed outputs."""
    V, H, W = depths.shape
    P, M_inv, centers, f = (torch.from_numpy(a).cuda() for a in fusion.camera_geometry(cams))
    d, im = torch.from_numpy(depths).cuda(), torch.from_numpy(images).cuda()
    counts = (depths > 0).reshape(V, -1).sum(axis=1)
    chunks = [np.arange(c0, min(c0 + ref_chunk, V)) for c0 in range(0, V, ref_chunk)]
    chunks = [(torch.from_numpy(i).cuda(), int(counts[i].max()), torch.from_numpy(counts[i]).cuda())
              for i in chunks]

    def check():
        outs = []
        for idxs, longest, n_valid in chunks:
            pix = fusion.valid_pixel_lists(d, idxs, longest) if sparse else None
            out = fusion.fuse_ref_chunk(idxs, pix, n_valid if sparse else None, d, im, P, M_inv,
                                        centers, f, 0.01, 2)
            outs.append(fusion.scatter_to_grid(out, pix, H * W) if sparse else out)
        return outs

    check()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    iters = 5
    start.record()
    for _ in range(iters):
        outs = check()
    end.record()
    torch.cuda.synchronize()
    check_ms = start.elapsed_time(end) / iters
    hosts = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
    start.record()
    for o, h in zip(outs, hosts):
        h.copy_(o, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return check_ms, start.elapsed_time(end), sum(o.numel() for o in outs), device_kernels(check)


def device_kernels(fn, top=8):
    """Device time of one call of fn by kernel (torch.profiler): (ms in index/gather kernels,
    ms in all kernels, the `top` kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in ("Buffer Flush", "Activity Buffer Request")]
    gather = sum(getattr(e, attr) for e in kernels
                 if any(k in e.key.lower() for k in ("gather", "index"))) / 1e3
    ranked = sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:top]
    return {"gather_ms": gather, "all_kernels_ms": sum(getattr(e, attr) for e in kernels) / 1e3,
            "launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "device_ms": getattr(e, attr) / 1e3, "calls": e.count}
                    for e in ranked]}


def phase_fusion(kind):
    for H, W, with_cpu, repeats in ((120, 224, True, 5), (480, 896, False, 3)):
        full_depths, images, cams = fusion_scene(12, H, W, seed=5)
        depths = with_holes(full_depths, 0.2, seed=6)
        V, ref_chunk = depths.shape[0], 4
        clouds, seconds, splits = {}, {}, {}
        for compact in ("never", "always", "auto"):
            fusion.fuse_depth_maps(depths, images, cams, compact=compact)          # warm
            times = []
            for _ in range(repeats):
                stats = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                clouds[compact] = fusion.fuse_depth_maps(depths, images, cams, compact=compact,
                                                         ref_chunk=ref_chunk, timings=stats)
                times.append(time.perf_counter() - t0)
            seconds[compact], splits[compact] = times, stats
        dense = clouds["never"]
        sparse_equal = all(np.array_equal(clouds[c][0], dense[0]) and np.array_equal(clouds[c][1], dense[1])
                           for c in ("always", "auto"))
        record = {}
        ok = sparse_equal and dense[0].shape[0] > 0.3 * V * H * W
        if with_cpu:
            t0 = time.perf_counter()
            cpu = fusion.fuse_depth_maps(depths, images, cams, compact="never", device="cpu")
            unmatched, colour = cloud_agreement(dense, cpu)
            record = {"cpu_points": int(cpu[0].shape[0]), "cpu_seconds": time.perf_counter() - t0,
                      "unmatched_share_vs_cpu": unmatched, "max_colour_diff_vs_cpu": colour,
                      "max_unmatched": FUSION_MAX_UNMATCHED, "colour_tol": FUSION_COLOUR_TOL}
            ok = ok and unmatched <= FUSION_MAX_UNMATCHED and colour <= FUSION_COLOUR_TOL
        b_ms, b_by = fusion_bound_ms(V, H, W, ref_chunk, kind)
        dense_ms, dense_dl_ms, dense_out, dense_kernels = fusion_device_ms(
            depths, images, cams, ref_chunk, False)
        sparse_ms, sparse_dl_ms, sparse_out, _ = fusion_device_ms(depths, images, cams, ref_chunk, True)
        emit(phase="fusion", views=V, size=[H, W], ref_chunk=ref_chunk,
             valid_share=float((depths > 0).mean()), points=int(dense[0].shape[0]),
             sparse_equals_dense=sparse_equal,
             seconds_each={k: v for k, v in seconds.items()},
             seconds_median={k: float(np.median(v)) for k, v in seconds.items()},
             split_of_last_run=splits, check_device_ms={"dense": dense_ms, "sparse": sparse_ms},
             download_ms={"dense": dense_dl_ms, "sparse": sparse_dl_ms},
             download_bytes={"dense": dense_out, "sparse": sparse_out},
             bound_ms=b_ms, bound_by=b_by, flop_per_check_assumed=FUSION_FLOP_PER_CHECK,
             check_over_bound=dense_ms / b_ms, dense_check_by_kernel=dense_kernels, **record, ok=ok)
        if not ok:
            raise AssertionError("fusion phase failed; see the line above")
    # Where the sparse path starts to pay: the 480x896 scene again with half and with a tenth
    # of the pixels left (random holes; a timing of the two paths, whose clouds must be equal)
    for hole_share in (0.5, 0.9):
        depths = with_holes(full_depths, hole_share, seed=7)
        seconds, clouds = {}, {}
        for compact in ("never", "always"):
            fusion.fuse_depth_maps(depths, images, cams, compact=compact)          # warm
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                clouds[compact] = fusion.fuse_depth_maps(depths, images, cams, compact=compact)
                times.append(time.perf_counter() - t0)
            seconds[compact] = float(np.median(times))
        equal = all(np.array_equal(a, b) for a, b in zip(clouds["never"], clouds["always"]))
        emit(phase="fusion", what="occupancy", views=12, size=[H, W],
             valid_share=float((depths > 0).mean()), points=int(clouds["never"][0].shape[0]),
             seconds_median=seconds, sparse_equals_dense=equal,
             check_device_ms={"dense": fusion_device_ms(depths, images, cams, 4, False)[0],
                              "sparse": fusion_device_ms(depths, images, cams, 4, True)[0]}, ok=equal)
        if not equal:
            raise AssertionError("fusion phase: sparse and dense clouds differ; see the line above")


def score_depth_maps(scene_dir, out_folder):
    """Every written depth map against the scene's ground truth, nearest-downsampled to the
    prediction's grid (no interpolation across the renderer's surface boundaries): the mean
    of eval.errors.calc_error over the reference views."""
    preds = sorted(p for p in glob.glob(os.path.join(out_folder, "*.pfm"))
                   if not p.endswith(("_prob.pfm", "_prob_filtered.pfm")))
    errs = []
    for p in preds:
        idx = int(os.path.basename(p).split(".")[0])
        d = np.asarray(load_pfm(p), np.float32)
        gt = np.asarray(load_pfm(os.path.join(scene_dir, "gt_depths", f"{idx:08d}.pfm")), np.float32)
        errs.append(calc_error(d, image_io.resize_to(gt, d.shape[1], d.shape[0], "nearest"))[0])
    return np.mean(np.stack(errs), axis=0), len(preds)


def phase_eval():
    """run_eval_pc and fuse_scene on a fabricated 12-image scene, through their entry points.
    Returns the soft-argmin launches of the batch-1 run."""
    h, w = EVAL_H // 4, EVAL_W // 4
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        scene_dir = os.path.join(root, "data", "eth3d", "spheres")
        write_eth3d_scene(scene_dir, EVAL_IMAGES, EVAL_H, EVAL_W, seed=0, depth_min=1.0,
                          depth_max=2.0, num_d=128, num_spheres=3)
        render_s = time.perf_counter() - t0
        kw = dict(view_num=EVAL_VIEWS, max_d=128, max_w=EVAL_W, max_h=EVAL_H, params_path=SPHERES)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        stats = run_eval_pc(os.path.join(root, "data"), os.path.join(root, "out"), ["spheres"], **kw)
        eval_s = time.perf_counter() - t0
        launches = S.softargmin_cuda.launches
        by_shape, by_path = dict(S.softargmin_cuda.shape_launches), dict(S.softargmin_cuda.path_launches)
        peak = torch.cuda.max_memory_allocated()
        out_folder = os.path.join(root, "out", "spheres", "depths_atvsnet")
        files = sorted(os.listdir(out_folder))
        expected = sorted(f"{v:08d}{s}" for v in range(EVAL_IMAGES)
                          for s in (".jpg", ".pfm", ".png", ".txt", "_prob.pfm"))
        depths = [load_pfm(os.path.join(out_folder, f"{v:08d}.pfm")) for v in range(EVAL_IMAGES)]
        confs = [load_pfm(os.path.join(out_folder, f"{v:08d}_prob.pfm")) for v in range(EVAL_IMAGES)]
        shapes_ok = all(d.shape == (h, w) and c.shape == (h, w) and np.isfinite(d).all()
                        and np.isfinite(c).all() for d, c in zip(depths, confs))
        errors, n_scored = score_depth_maps(scene_dir, out_folder)
        mae, inlier3 = float(errors[0]), float(errors[11])

        # batch=2 on the card is another result than batch=1 (see BATCH_MEAN_DIFF): held to
        # the bounds of a batched pass, with cuDNN's default algorithms on both sides
        S.reset_launch_counts()
        t0 = time.perf_counter()
        stats2 = run_eval_pc(os.path.join(root, "data"), os.path.join(root, "out2"), ["spheres"],
                             batch=2, **kw)
        eval2_s = time.perf_counter() - t0
        by_shape2 = dict(S.softargmin_cuda.shape_launches)
        folder2 = os.path.join(root, "out2", "spheres", "depths_atvsnet")
        batch_agree = depth_differences(
            {"depth": np.stack([load_pfm(os.path.join(folder2, f"{v:08d}.pfm")) for v in range(EVAL_IMAGES)])},
            {"depth": np.stack(depths)}, ("depth",))

        # fusion at the defaults (tau 0.8, disparity 0.01, 2 consistent views), then its parts
        # once more on the same tree, each on the host's clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ply = fuse_scene(os.path.join(root, "out", "spheres"))
        torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
        points, colours = read_ply(ply)
        parts = {}
        t0 = time.perf_counter()
        probability_filter(out_folder, 0.8)
        parts["probability_filter_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f_depths, f_images, f_cams, _ = load_scene(out_folder)
        parts["load_scene_s"] = time.perf_counter() - t0
        check = {}
        t0 = time.perf_counter()
        again = fusion.fuse_depth_maps(f_depths, f_images, f_cams, depth_min=0.01, depth_max=1e5,
                                       timings=check)
        parts["fuse_depth_maps_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_ply(os.path.join(root, "again.ply"), again[0], again[1][:, ::-1])
        parts["write_ply_s"] = time.perf_counter() - t0
        valid_share = float((f_depths > 0).mean())
        same_cloud = np.array_equal(again[0], points) and np.array_equal(again[1][:, ::-1], colours)

    bounds_ok = mae < EVAL_MAX_MAE and inlier3 > EVAL_MIN_INLIER3 and points.shape[0] > EVAL_MIN_POINTS
    ok = (files == expected and shapes_ok and n_scored == EVAL_IMAGES and by_shape == EVAL_SHAPES
          and by_path["aligned"] == launches and by_shape2 == EVAL_BATCH2_SHAPES
          and within_batch_bounds(batch_agree) and bounds_ok and same_cloud
          and np.isfinite(points).all())
    steady = stats["batch_seconds"][1:]
    emit(phase="eval", scene={"images": EVAL_IMAGES, "size": [EVAL_H, EVAL_W], "spheres": 3, "seed": 0},
         view_num=EVAL_VIEWS, max_d=128, dtype="float32", render_seconds=render_s,
         launches=launches, launches_by_shape=shape_counts(by_shape), launches_by_path=by_path,
         expected_launches=shape_counts(EVAL_SHAPES), files_ok=files == expected, shapes_ok=shapes_ok,
         run_eval_pc_seconds=eval_s, scene_seconds=stats["scenes"]["spheres"]["seconds"],
         maps_per_s=stats["scenes"]["spheres"]["maps_per_s"], blocked=stats["blocked"],
         first_batch_s=stats["batch_seconds"][0], steady_batch_s_median=float(np.median(steady)),
         steady_batch_s_each=steady, peak_memory_bytes=peak,
         mae=mae, inlier3=inlier3, inlier1=float(errors[10]), abs_relative=float(errors[7]),
         confident_share=float(np.mean([(c >= 0.8).mean() for c in confs])),
         bounds={"mae_below": EVAL_MAX_MAE, "inlier3_above": EVAL_MIN_INLIER3,
                 "points_above": EVAL_MIN_POINTS}, bounds_ok=bounds_ok,
         batch2={"run_eval_pc_seconds": eval2_s, "maps_per_s": stats2["scenes"]["spheres"]["maps_per_s"],
                 "steady_batch_s_median": float(np.median(stats2["batch_seconds"][1:])),
                 "launches_by_shape": shape_counts(by_shape2), "vs_batch1": batch_agree,
                 "batch_mean_diff": BATCH_MEAN_DIFF, "batch_diff_at": BATCH_DIFF_AT,
                 "batch_max_share": BATCH_MAX_SHARE},
         fuse_scene_seconds=fuse_s, points=int(points.shape[0]), valid_share_after_filter=valid_share,
         fusion_parts=parts, fuse_depth_maps_split=check, parts_give_the_same_cloud=same_cloud, ok=ok)
    if not ok:
        raise AssertionError("eval phase failed; see the line above")
    return launches


def train_batch(cfg, seed, num_spheres=2):
    s = render_multiplane_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w, D=cfg.max_d,
                                seed=seed, num_spheres=num_spheres)
    return {k: s[k] for k in ("images", "cams", "depth_gt")}


def grad_rel(got: dict, want: dict) -> float:
    """Global relative difference of two {name: gradient} dicts."""
    num = sum(float((got[n].float().cpu() - want[n].float().cpu()).square().sum()) for n in want)
    return (num / sum(float(want[n].float().cpu().square().sum()) for n in want)) ** 0.5


def launch_record() -> dict:
    return {d: {"launches": fn.launches, "by_path": dict(fn.path_launches),
                "by_shape": shape_counts(fn.shape_launches)}
            for d, fn in (("forward", S.softargmin_cuda), ("backward", S.softargmin_backward_cuda))}


def phase_train():
    """Training: (a) the kernel route against impl="torch" on the card, (b) against the
    CPU, (c) the CLI, (d) one flagship-size step with remat off and on. Returns the
    forward and backward kernels' launches in the CLI run."""
    cfg = PipelineConfig(**TRAIN_SIZE)                      # fp32
    batch = train_batch(cfg, seed=3)
    model = load_model(SPHERES, cfg, device="cuda").requires_grad_(True)

    # (a) kernel route against the plain route, same inputs and weights, deterministic cuDNN
    torch.backends.cudnn.deterministic = True
    rows, ok = {}, True
    for (remat, conf), expected in TRAIN_LAUNCHES.items():
        c, t = cfg.replace(remat=remat), TrainConfig(loss_weight_confidence=conf)
        torch.cuda.synchronize()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        loss_k, _, g_k = loss_and_grads(model, batch, c.replace(softargmin_impl="cuda"), t)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = launch_record()
        t0 = time.perf_counter()
        loss_p, _, g_p = loss_and_grads(model, batch, c.replace(softargmin_impl="torch"), t)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        rel = grad_rel(g_k, g_p)
        finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
        row_ok = ((launches["forward"]["launches"], launches["backward"]["launches"]) == expected
                  and all(launches[d]["by_shape"] == {"x".join(map(str, TRAIN_SHAPE)): n}
                          for d, n in zip(("forward", "backward"), expected))
                  and all(launches[d]["by_path"]["scalar"] == 0 for d in launches)
                  and loss_rel <= TRAIN_LOSS_RTOL and rel <= TRAIN_GRAD_REL and finite)
        rows[f"remat={remat} conf_weight={conf}"] = {
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
            "grad_rel": rel, "finite": finite, "expected_launches": list(expected),
            "launches": launches, "seconds_kernel": kernel_s, "seconds_plain": plain_s, "ok": row_ok}
        ok = ok and row_ok
        if (remat, conf) == (False, 0.0):
            card_loss, card_grads = float(loss_k), {n: g.cpu() for n, g in g_k.items()}
        del g_k, g_p
    torch.backends.cudnn.deterministic = False
    emit(phase="train", part="a: kernel route vs plain route on the card", size=TRAIN_SIZE,
         dtype="float32", loss_rtol=TRAIN_LOSS_RTOL, grad_rel_bound=TRAIN_GRAD_REL, runs=rows, ok=ok)
    if not ok:
        raise AssertionError("train (a): kernel and plain routes disagree or launches are wrong")
    del model

    # (b) the same step on the CPU (PyTorch's own convolutions: see cli/train.py)
    cpu_model = load_model(SPHERES, cfg, device="cpu").requires_grad_(True)
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        loss_c, _, g_c = loss_and_grads(cpu_model, batch, cfg, TrainConfig())
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(card_loss - float(loss_c)) / abs(float(loss_c))
    rel = grad_rel(card_grads, g_c)
    ok = loss_rel <= TRAIN_CPU_LOSS_RTOL and all(bool(torch.isfinite(g).all()) for g in g_c.values())
    emit(phase="train", part="b: card vs cpu", loss_card=card_loss, loss_cpu=float(loss_c),
         loss_rel=loss_rel, loss_rtol=TRAIN_CPU_LOSS_RTOL, grad_rel=rel, cpu_seconds=cpu_s,
         cpu_threads=torch.get_num_threads(), ok=ok)
    if not ok:
        raise AssertionError("train (b): the card's loss is not the CPU's")
    del cpu_model, g_c, card_grads

    # (c) the CLI at its defaults (bf16), from init_model, into a temp dir
    with tempfile.TemporaryDirectory() as tmp:
        state_path, export = os.path.join(tmp, "state.npz"), os.path.join(tmp, "params.npz")
        args = ["--synthetic_planes", "--num_spheres", "2", "--device", "cuda", "--ckpt",
                state_path, "--log_every", "10"]
        torch.cuda.empty_cache()
        S.reset_launch_counts()
        run = train_cli.main(args + ["--steps", str(CLI_STEPS), "--export_params", export])
        cli_launches = launch_record()
        resumed = train_cli.main(args + ["--steps", str(CLI_STEPS + 5), "--resume"])
        exported = load_model(export, cfg, device="cuda")
        scene = train_batch(cfg, seed=31)
        out = multi_view_forward(exported, scene["images"], scene["cams"], cfg)
        forward_finite = bool(torch.isfinite(out["depth"]).all())
        mae = float((out["depth"].cpu() - torch.from_numpy(scene["depth_gt"])).abs().mean())
        # one loss and backward of the CLI's step on the device's clock, then under the
        # profiler: how much of the step the device spends in kernels, and how many
        bf16 = cfg.replace(compute_dtype="bfloat16")
        exported.requires_grad_(True)
        loss_and_grads(exported, scene, bf16, TrainConfig())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_and_grads(exported, scene, bf16, TrainConfig())
        torch.cuda.synchronize()
        one_step = {"seconds": time.perf_counter() - t0,
                    **device_kernels(lambda: loss_and_grads(exported, scene, bf16, TrainConfig()))}
    per_step = TRAIN_LAUNCHES[(False, 0.0)]
    expected = {"x".join(map(str, TRAIN_SHAPE)): CLI_STEPS * per_step[0]}
    ok = (run["step"] == CLI_STEPS and len(run["losses"]) == CLI_STEPS // 10
          and all(math.isfinite(v) for _, v in run["losses"] + resumed["losses"])
          and (resumed["start_step"], resumed["step"]) == (CLI_STEPS, CLI_STEPS + 5)
          and cli_launches["forward"]["by_shape"] == expected
          and cli_launches["backward"]["by_shape"] == expected
          and all(cli_launches[d]["by_path"]["scalar"] == 0 for d in cli_launches)
          and forward_finite)
    emit(phase="train", part="c: cli.train.main", argv=args[:5] + ["--steps", str(CLI_STEPS)],
         size=TRAIN_SIZE, dtype="bfloat16", losses=run["losses"], first_step_seconds=run["first_step_s"],
         steps_per_s=run["steps_per_s"], peak_memory_bytes=run["peak_memory_bytes"],
         launches=cli_launches, expected_by_shape=expected,
         resumed={"start_step": resumed["start_step"], "step": resumed["step"],
                  "losses": resumed["losses"], "steps_per_s": resumed["steps_per_s"]},
         exported_forward={"finite": forward_finite, "mae_sweep_units_vs_gt": mae},
         loss_and_backward=one_step, ok=ok)
    if not ok:
        raise AssertionError("train (c): the CLI run failed; see the line above")

    # (d) one fp32 train step at the flagship size with the spheres weights, remat off, on
    flag = PipelineConfig()
    flag_batch = train_batch(flag, seed=21)
    for remat in (False, True):
        c = flag.replace(remat=remat)
        torch.cuda.empty_cache()
        model = load_model(SPHERES, c, device="cuda")
        opt = make_optimizer(TrainConfig())
        state = init_train_state(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, losses = [], []
        for _ in range(2):          # the first step includes cuDNN's algorithm search
            S.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = train_step(state, flag_batch, c, TrainConfig(), opt)
            losses.append(float(metrics["loss"]))
            seconds.append(time.perf_counter() - t0)
        launches = launch_record()
        peak = torch.cuda.max_memory_allocated()
        ok = all(math.isfinite(v) for v in losses)
        # a third step under the profiler: device time by kind of kernel
        split = device_kernels(lambda: train_step(state, flag_batch, c, TrainConfig(), opt), top=12)
        emit(phase="train", part="d: flagship step", view_num=c.view_num, size=[c.max_h, c.max_w],
             max_d=c.max_d, dtype="float32", remat=remat, seconds_each=seconds, losses=losses,
             peak_memory_bytes=peak, launches_per_step=launches, profiled_step=split, ok=ok)
        if not ok:
            raise AssertionError("train (d): non-finite loss at the flagship size")
        del model, state, opt
    return cli_launches


def _rank_main(rank: int, size: int, init: dict, results, fn, args):
    """One rank of a world phase_parallel starts: gloo over CUDA tensors on cuda:0 from a
    FileStore, or (init["backend"] == "nccl") torchrun's environment, from which
    make_mesh starts NCCL with one card per rank. Its result or its traceback goes to the
    parent, which fails the run on any error."""
    try:
        if init["backend"] == "gloo":
            torch.cuda.set_device(0)
            dist.init_process_group("gloo", store=dist.FileStore(init["store"], size),
                                    rank=rank, world_size=size)
        else:
            os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(init["port"]),
                              RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size))
        try:
            results.put((rank, "ok", fn(*args)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(size: int, init: dict, fn, *args) -> list:
    """fn(*args) on every rank of a world of `size` child processes, in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, size, init, results, fn, args))
             for r in range(size)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) < size and not errors:
            rank, status, value = results.get(timeout=PARALLEL_RESULT_TIMEOUT_S)
            if status == "ok":
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    except queue.Empty:
        errors.append(f"{size - len(got)} rank(s) gave no result in {PARALLEL_RESULT_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if errors or bad:
        raise AssertionError(f"parallel: a rank failed (exit codes {bad})\n" + "\n".join(errors))
    return [got[r] for r in range(size)]


def parallel_scenes(cfg, n):
    """n flagship scenes (synthetic_scene seeds 0..n-1) as one batch."""
    scenes = [synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w, D=cfg.max_d,
                              seed=s) for s in range(n)]
    return np.concatenate([i for i, _ in scenes]), np.concatenate([c for _, c in scenes])


def parallel_train_batch(cfg):
    """Two train-size scenes; the second row keeps ~30% of its ground truth."""
    rows = [train_batch(cfg, seed=s) for s in (3, 4)]
    batch = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    drop = np.random.RandomState(0).rand(*batch["depth_gt"][1].shape) < 0.7
    batch["depth_gt"][1][drop] = 0.0
    return batch


def sharded_run(mesh, model, cfg, images, cams) -> dict:
    """A warm sharded flagship forward, then the counted one: seconds, peak memory,
    launches and the whole batch's depths."""
    fwd = sharded_forward(mesh, cfg)
    fwd(model, images, cams)         # cuDNN's algorithm choice and the allocator's growth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launch_counts()
    t0 = time.perf_counter()
    out = fwd(model, images, cams)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": S.softargmin_cuda.launches, "by_path": dict(S.softargmin_cuda.path_launches),
            "by_shape": dict(S.softargmin_cuda.shape_launches),
            "depths": {k: out[k].cpu().numpy() for k in DEPTH_KEYS},
            "mesh": [mesh.n_data, mesh.n_view], "data_rank": mesh.data_rank,
            "view_rank": mesh.view_rank}


def parallel_shared_card():
    """(a) and (b) on one rank of the 2-rank gloo world on cuda:0."""
    torch.backends.cudnn.deterministic = True
    cfg = PipelineConfig()
    model = load_model(SPHERES, cfg, device="cuda:0")
    images, cams = parallel_scenes(cfg, 2)
    res = {}
    for name, shape, rows in (("view=2", (1, 2), 1), ("data=2", (2, 1), 2)):
        res[name] = sharded_run(make_mesh(*shape, device="cuda:0"), model, cfg, images[:rows],
                                cams[:rows])
    del model
    torch.cuda.empty_cache()
    tcfg_size = PipelineConfig(**TRAIN_SIZE)
    batch = parallel_train_batch(tcfg_size)
    for name, shape in (("train data=2", (2, 1)), ("train view=2", (1, 2))):
        mesh = make_mesh(*shape, device="cuda:0")
        model = load_model(SPHERES, tcfg_size, device="cuda:0").requires_grad_(True)
        torch.cuda.synchronize()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics, grads = loss_and_grads(model, batch, tcfg_size, TrainConfig(), mesh)
        torch.cuda.synchronize()
        res[name] = {"seconds": time.perf_counter() - t0, "loss": float(loss),
                     "launches": launch_record(),
                     "grads": {n: g.cpu().numpy() for n, g in grads.items()}}
    return res


def parallel_nccl(size: int):
    """(c) on one rank of the NCCL world: one card per rank, make_mesh from the environment."""
    torch.backends.cudnn.deterministic = True
    cfg = PipelineConfig()
    mesh = make_mesh(*auto_mesh_shape(size, cfg.view_num - 1))
    model = load_model(SPHERES, cfg, device=mesh.device)
    images, cams = parallel_scenes(cfg, mesh.n_data)
    return dict(sharded_run(mesh, model, cfg, images, cams), backend=dist.get_backend(),
                device=str(mesh.device))


def phase_parallel() -> dict:
    """The multi-device layer: (a), (b) and (c) of the module docstring. Returns the
    forward and backward kernels' launches over every rank's counted runs."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        shared = run_ranks(2, {"backend": "gloo", "store": os.path.join(tmp, "store")},
                           parallel_shared_card)
    count = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    nccl = run_ranks(count, {"backend": "nccl", "port": port}, parallel_nccl, count)

    # the references, in this process once the worlds are done
    torch.backends.cudnn.deterministic = True
    cfg = PipelineConfig()
    model = load_model(SPHERES, cfg, device="cuda")
    n_rows = max(2, nccl[0]["mesh"][0])
    images, cams = parallel_scenes(cfg, n_rows)
    single = [multi_view_forward(model, images[i:i + 1], cams[i:i + 1], cfg) for i in range(n_rows)]
    single = {k: torch.cat([o[k].cpu() for o in single], dim=1 if k == "depth_views" else 0)
              for k in DEPTH_KEYS}
    del model
    tcfg_size = PipelineConfig(**TRAIN_SIZE)
    model = load_model(SPHERES, tcfg_size, device="cuda").requires_grad_(True)
    loss_1, _, grads_1 = loss_and_grads(model, parallel_train_batch(tcfg_size), tcfg_size,
                                        TrainConfig())
    grads_1 = {n: g.cpu() for n, g in grads_1.items()}
    del model
    torch.backends.cudnn.deterministic = False

    def rows(n):
        return {k: v[:, :n] if k == "depth_views" else v[:n] for k, v in single.items()}

    def forward_record(ranks):
        n = ranks[0]["mesh"][0]
        agree = depth_differences(ranks[0]["depths"], rows(n), DEPTH_KEYS)
        same = all(np.array_equal(r["depths"][k], ranks[0]["depths"][k])
                   for r in ranks for k in DEPTH_KEYS)
        expected = parallel_shapes((cfg.view_num - 1) // ranks[0]["mesh"][1])
        launches_ok = all(r["by_shape"] == expected and r["by_path"]["scalar"] == 0 for r in ranks)
        return {"mesh": ranks[0]["mesh"], "vs_one_process": agree,
                "ranks_agree_to_the_bit": same,
                "per_rank": [{"seconds": r["seconds"], "peak_bytes": r["peak_bytes"],
                              "launches": r["launches"], "by_shape": shape_counts(r["by_shape"])}
                             for r in ranks],
                "expected_by_shape": shape_counts(expected),
                "ok": within_batch_bounds(agree) and same and launches_ok}

    a = {name: forward_record([r[name] for r in shared]) for name in ("view=2", "data=2")}
    ok_a = all(v["ok"] for v in a.values())
    emit(phase="parallel", part="a: 2 ranks sharing cuda:0 over gloo", runs=a,
         batch_mean_diff=BATCH_MEAN_DIFF, batch_diff_at=BATCH_DIFF_AT,
         batch_max_share=BATCH_MAX_SHARE, ok=ok_a)

    b, ok_b = {}, True
    expected_train = TRAIN_LAUNCHES[(False, 0.0)]
    for name in ("train data=2", "train view=2"):
        per = []
        for r in shared:
            res = r[name]
            loss_rel = abs(res["loss"] - float(loss_1)) / abs(float(loss_1))
            rel = grad_rel({n: torch.from_numpy(g) for n, g in res["grads"].items()}, grads_1)
            per.append({"loss": res["loss"], "loss_rel": loss_rel, "grad_rel": rel,
                        "seconds": res["seconds"], "launches": res["launches"]})
        # per rank and step: data=2 runs the one-row loss (4 forward, 4 backward launches),
        # view=2 one pair of stage 1 fewer (3 and 3) on the train shape
        want = expected_train if name.endswith("data=2") else tuple(n - 1 for n in expected_train)
        row_ok = all(p["loss_rel"] <= PARALLEL_LOSS_RTOL and p["grad_rel"] <= PARALLEL_GRAD_REL
                     and (p["launches"]["forward"]["launches"],
                          p["launches"]["backward"]["launches"]) == want for p in per)
        b[name] = {"per_rank": per, "expected_launches": list(want), "ok": row_ok}
        ok_b = ok_b and row_ok
    emit(phase="parallel", part="b: sharded train step on the same world", size=TRAIN_SIZE,
         dtype="float32", loss_one_process=float(loss_1), loss_rtol=PARALLEL_LOSS_RTOL,
         grad_rel_bound=PARALLEL_GRAD_REL, runs=b, ok=ok_b)

    c = forward_record(nccl)
    ok_c = c["ok"] and all(r["backend"] == "nccl" for r in nccl)
    emit(phase="parallel", part="c: one rank per card over NCCL", world_size=count,
         devices=[r["device"] for r in nccl], backend=[r["backend"] for r in nccl], run=c,
         ok=ok_c)

    # (d) the eval CLI as a user starts it, one process per card
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        write_eth3d_scene(os.path.join(tmp, "eth3d", "s0"), 4, PARALLEL_EVAL["max_h"],
                          PARALLEL_EVAL["max_w"], 0, num_d=PARALLEL_EVAL["max_d"], num_spheres=2)
        argv = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={count}",
                "-m", "atvsnet_torch.cli.eval_pointcloud", "--mesh", f"data={count}",
                "--data_root", tmp, "--savepath", os.path.join(tmp, "sharded"), "--scenes", "s0",
                "--params", SPHERES] + [f"--{k}={v}" for k, v in PARALLEL_EVAL.items()]
        t0 = time.perf_counter()
        cli = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"parallel (d): torchrun exited {cli.returncode}\n{cli.stderr[-4000:]}")
        torch.backends.cudnn.deterministic = True
        run_eval_pc(tmp, os.path.join(tmp, "plain"), ["s0"], params_path=SPHERES, **PARALLEL_EVAL)
        torch.backends.cudnn.deterministic = False
        folders = [os.path.join(tmp, k, "s0", "depths_atvsnet") for k in ("sharded", "plain")]
        same_files = sorted(os.listdir(folders[0])) == sorted(os.listdir(folders[1]))
        maps = [{"depth": np.stack([load_pfm(os.path.join(f, f"{i:08d}.pfm")) for i in range(4)])}
                for f in folders]
    agree = depth_differences(maps[0], maps[1], ("depth",))
    ok_d = same_files and within_batch_bounds(agree)
    emit(phase="parallel", part="d: cli.eval_pointcloud under torchrun", argv=argv[2:8],
         seconds=cli_s, same_files=same_files, vs_unsharded=agree, ok=ok_d)
    if not (ok_a and ok_b and ok_c and ok_d):
        raise AssertionError("parallel: a sharded run disagrees or launched wrong; see above")
    forward = (sum(r[n]["launches"] for r in shared for n in ("view=2", "data=2"))
               + sum(r[n]["launches"]["forward"]["launches"] for r in shared for n in b)
               + sum(r["launches"] for r in nccl))
    backward = sum(r[n]["launches"]["backward"]["launches"] for r in shared for n in b)
    return {"forward": forward, "backward": backward}


# ---- the quant phase ----

def phase_quant():
    """Each storage quantization (QUANT_MODES): the card against the CPU at the small size
    (bounded), then the flagship forward in turns with the unquantized forward,
    deterministic cuDNN: median seconds of QUANT_ROUNDS forwards, peak memory, and
    |depth - unquantized depth| in sweep units and in planes."""
    torch.backends.cudnn.deterministic = True
    small = PipelineConfig(view_num=3, max_d=32, max_h=64, max_w=96)
    scene = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
    models = {dev: load_model(SPHERES, small, device=dev) for dev in ("cuda", "cpu")}
    for part, modes in (("the card against the CPU", QUANT_MODES),
                        ("the card against the CPU, bf16", QUANT_BF16_MODES)):
        vs_cpu, ok_small = {}, True
        for name, kw in modes.items():
            got = {dev: multi_view_forward(m, scene["images"], scene["cams"], small.replace(**kw))
                   ["depth"].float().cpu() for dev, m in models.items()}
            d = (got["cuda"] - got["cpu"]).abs()
            vs_cpu[name] = {"mean_abs": float(d.mean()), "max_abs": float(d.max())}
            ok_small = (ok_small and bool(torch.isfinite(got["cuda"]).all())
                        and vs_cpu[name]["mean_abs"] <= QUANT_MEAN_DIFF
                        and vs_cpu[name]["max_abs"] <= QUANT_MAX_DIFF)
        emit(phase="quant", part=part, view_num=3, size=[64, 96], max_d=32,
             scene="render_multiplane_scene(seed=11, num_spheres=2)", modes=vs_cpu,
             mean_bound=QUANT_MEAN_DIFF, max_bound=QUANT_MAX_DIFF, ok=ok_small)
        if not ok_small:
            raise AssertionError(f"quant: {part}: the card's quantized forward is not the CPU's")
    del models
    cfg = PipelineConfig()
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    configs = {"none": cfg, **{n: cfg.replace(**kw) for n, kw in QUANT_MODES.items()}}
    outs = {}
    for name, c in configs.items():   # warm: cuDNN's algorithm choice, and the depths
        out = multi_view_forward(model, images, cams, c)
        outs[name] = {k: out[k].cpu() for k in ("depth", "depth_agg_initial", "depth_views")}
    seconds = {name: [] for name in configs}
    peaks = dict.fromkeys(configs, 0)
    for _ in range(QUANT_ROUNDS):
        for name, c in configs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            multi_view_forward(model, images, cams, c)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
    torch.backends.cudnn.deterministic = False
    interval = float(cams[0, 0, 1, 3, 1])
    ok, rows = True, {}
    for name in configs:
        diff = {k: {"mean_abs": float((outs[name][k] - outs["none"][k]).abs().mean()),
                    "max_abs": float((outs[name][k] - outs["none"][k]).abs().max()),
                    "mean_planes": float((outs[name][k] - outs["none"][k]).abs().mean()) / interval}
                for k in outs[name]}
        finite = all(bool(torch.isfinite(v).all()) for v in outs[name].values())
        rows[name] = {"config": QUANT_MODES.get(name, {}), "seconds_each": seconds[name],
                      "seconds_median": float(np.median(seconds[name])),
                      "peak_memory_bytes": peaks[name], "vs_unquantized": diff, "finite": finite}
        ok = ok and finite
    # the same size on a rendered scene, whose depth is well defined: how far each mode
    # moves it, and its error against the ground truth
    rendered = train_batch(cfg, seed=21)
    gt = torch.from_numpy(rendered["depth_gt"])
    valid = gt > 0
    torch.backends.cudnn.deterministic = True
    depths = {name: multi_view_forward(model, rendered["images"], rendered["cams"], c)["depth"].cpu()
              for name, c in configs.items()}
    torch.backends.cudnn.deterministic = False
    r_interval = float(rendered["cams"][0, 0, 1, 3, 1])
    for name, d in depths.items():
        moved = (d - depths["none"]).abs()
        rows[name]["rendered_scene"] = {
            "vs_unquantized": {"mean_abs": float(moved.mean()), "max_abs": float(moved.max())},
            "mae_vs_ground_truth_planes": float((d - gt).abs()[valid].mean()) / r_interval}
        ok = ok and bool(torch.isfinite(d).all())
    emit(phase="quant", part="the flagship forward", view_num=cfg.view_num,
         size=[cfg.max_h, cfg.max_w], max_d=cfg.max_d, dtype=cfg.compute_dtype,
         depth_interval=interval, rendered_depth_interval=r_interval,
         rendered_scene="render_multiplane_scene(seed=21, num_spheres=2) at the same size",
         cudnn_deterministic=True, rounds=QUANT_ROUNDS, order=list(configs), modes=rows,
         jax_probe_mean_for_comparison=0.0022, ok=ok)
    if not ok:
        raise AssertionError("quant: a quantized flagship forward is not finite")


# ---- the precision phase ----

def precision_leaf_cases():
    """(name, x shape channel-last, w shape, ConvSpec or None for a matmul, pads before the
    conv (F.pad order) or None): every leaf kind at the flagship's shapes (5 views, 480x896,
    D=128: the FEM at 480x896 and 120x224, the volumes at (128, 120, 224) and halvings)."""
    spec = fp32_passes.ConvSpec.of
    return [
        ("FEM conv0_0, 2D 3->32 s2", (5, 480, 896, 3), (32, 3, 3, 3), spec(2, 2), (0, 1, 0, 1)),
        ("FEM dilated residual, 2D 64->64 rate 2", (5, 120, 224, 64), (64, 64, 3, 3),
         spec(2, 1, 2, 2), None),
        ("CRM 3D 8->8", (1, 128, 120, 224, 8), (8, 8, 3, 3, 3), spec(3, 1, 1), None),
        ("CRM 3D 8->16 s2", (1, 128, 120, 224, 8), (16, 8, 3, 3, 3), spec(3, 2),
         (0, 1, 0, 1, 0, 1)),
        ("CRM 3D deconv 16->8 s2", (1, 64, 60, 112, 16), (16, 8, 3, 3, 3),
         spec(3, 2, transposed=True), None),
        ("AAM 3D 8->16 [unique | shared]", (4, 128, 120, 224, 8), (16, 8, 3, 3, 3),
         spec(3, 1, 1), None),
        ("depthwise 2D 64, rate 2", (5, 120, 224, 64), (64, 1, 3, 3), spec(2, 1, 2, 2, 64), None),
        ("dense 128->32", (5, 120, 224, 128), (128, 32), None, None),
    ]


def precision_leaf(name, x_shape, w_shape, spec, pads, seed) -> tuple[dict, bool]:
    """One leaf kind in every mode and plain TF32 on the card, held to the float64 plain
    versions (see PRECISION_FLOOR). Returns its record and whether it held."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(x_shape, device="cuda", generator=g)
    if spec is not None:
        x = x.movedim(-1, 1)                               # the model's channels-last views
        if pads is not None:
            x = torch.nn.functional.pad(x, pads)
    w = torch.randn(w_shape, device="cuda", generator=g) * (1.0 / math.prod(w_shape[1:])) ** 0.5
    if spec is None:
        def run(mode, a, b):
            return fp32_passes.pass_matmul(a, b, mode)
        raw = {"forward": torch.matmul, "grad_input": lambda a, g_, b: g_ @ b.T,
               "grad_weight": lambda a, g_, b: a.reshape(-1, a.shape[-1]).T @ g_.reshape(
                   -1, g_.shape[-1])}
        plain = lambda mode, gr: fp32_passes.matmul_plain(x, w, mode, gr)
        exact = lambda gr, mag: fp32_passes.matmul_exact(x, w, gr, mag)
    else:
        def run(mode, a, b):
            if spec.transposed:
                return fp32_passes.pass_conv_transpose(a, b, mode, spec.stride)
            return fp32_passes.pass_conv(a, b, mode, spec.stride, spec.padding, spec.dilation,
                                         spec.groups)
        raw = {"forward": spec.forward, "grad_input": lambda a, g_, b: spec.grad_input(a, g_, b),
               "grad_weight": lambda a, g_, b: spec.grad_weight(a, g_, b)}
        plain = lambda mode, gr: fp32_passes.conv_plain(x, w, mode, spec, gr)
        exact = lambda gr, mag: fp32_passes.conv_exact(x, w, spec, gr, mag)

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    before, flags_kept = flags(), True
    outs, seconds = {}, {}
    gr = None
    for mode in ("highest",) + FP32_PRECISION_MODES[1:]:
        xr, wr = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        y = run(mode, xr, wr)
        flags_kept = flags_kept and flags() == before
        if gr is None:
            gr = torch.randn(y.shape, device="cuda", generator=g)
        y.backward(gr)
        flags_kept = flags_kept and flags() == before
        outs[mode] = {"forward": y.detach(), "grad_input": xr.grad, "grad_weight": wr.grad}
        del y, xr, wr
        with torch.no_grad():
            seconds[mode] = device_ms(lambda a, b: run(mode, a, b), [(x, w)], 5)
    # plain TF32 on the unrounded operands (torch's own "high"): a yardstick, neither mode
    with fp32_passes.tf32(True):
        tf32 = {"forward": raw["forward"](x, w), "grad_input": raw["grad_input"](x, gr, w),
                "grad_weight": raw["grad_weight"](x, gr, w)}
        seconds["tf32"] = device_ms(raw["forward"], [(x, w)], 5)
    # "highest" is a call with TF32 off, to the bit (a conv: aten's forward and backward)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if spec is None:
            off = {"forward": raw["forward"](x, w), "grad_input": raw["grad_input"](x, gr, w),
                   "grad_weight": raw["grad_weight"](x, gr, w)}
        else:
            gx, gw, _ = spec.backward(x, gr, w, [True, True, False])
            off = {"forward": spec.forward(x, w), "grad_input": gx, "grad_weight": gw}
            del gx, gw
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    highest_bits = all(torch.equal(outs["highest"][k], off[k]) for k in off)
    del off
    scale = {k: float(v.max()) for k, v in exact(gr, True).items()}
    ref = exact(gr, False)

    def rel(got, want, k):
        return float((got.double() - want).abs().max()) / scale[k]

    e = {k: rel(outs["highest"][k], ref[k], k) for k in ref}
    bound = {k: max(PRECISION_FLOOR, 4 * e[k]) for k in ref}
    row = {"highest": {"vs_exact": e}, "tf32": {"vs_exact": {k: rel(tf32[k], ref[k], k) for k in ref}}}
    ok = flags_kept and highest_bits
    for mode in FP32_PRECISION_MODES[1:]:
        want = plain(mode, gr)
        err = {k: rel(outs[mode][k], want[k], k) for k in want}
        tf32_err = {k: rel(tf32[k], want[k], k) for k in want}
        row[mode] = {"vs_plain": err, "vs_exact": {k: rel(outs[mode][k], ref[k], k) for k in ref},
                     "tf32_vs_plain": tf32_err}
        # TF32 must miss the bound where its 10-bit operands show: the forward and
        # grad_input; a grad_weight sums millions of products whose rounding errors
        # average out, so TF32's is only reported
        ok = (ok and all(err[k] <= bound[k] for k in want)
              and all(tf32_err[k] > bound[k] for k in ("forward", "grad_input")))
        del want
    record = {"leaf": name, "x": list(x.shape), "w": list(w.shape),
              "spec": None if spec is None else dataclasses.asdict(spec), "bound": bound,
              "errors_over_max_sum_abs": row, "forward_ms": seconds,
              "flags_restored": flags_kept, "highest_equals_tf32_off": highest_bits, "ok": ok}
    return record, ok


def precision_forward_rows(model, scene, cfg, modes) -> dict:
    """Depths of each mode's forward on `scene` (deterministic cuDNN)."""
    return {m: multi_view_forward(model, scene["images"], scene["cams"],
                                  cfg.replace(fp32_precision=m))["depth"].float().cpu()
            for m in modes}


def conv_kernel_profile(fn) -> dict:
    """Device ms of one call of fn in cuDNN / cuBLAS kernels (phase_profile's category), the
    part of it in TF32 tensor-core kernels (a "tf32" in the name), and the top names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    keys = ("conv", "xmma", "gemm", "fft", "Tensor5d", "nchw", "nhwc", "DSE::",
            "region_transform", "sm90", "sm80", "cutlass")
    convs = [e for e in events if e.device_type == DeviceType.CUDA
             and any(k.lower() in e.key.lower() for k in keys)]
    top = sorted(convs, key=lambda e: getattr(e, attr), reverse=True)[:8]
    return {"conv_gemm_ms": sum(getattr(e, attr) for e in convs) / 1e3,
            "tf32_named_ms": sum(getattr(e, attr) for e in convs if "tf32" in e.key.lower()) / 1e3,
            "top": [{"name": e.key[:100], "device_ms": getattr(e, attr) / 1e3, "calls": e.count}
                    for e in top]}


def phase_precision():
    """fp32_precision on the card: (a) the leaves against their float64 plain versions at the
    flagship's shapes, (b) the small trained forward against the CPU per mode, (c) the
    flagship forward per mode in turns, (d) one train-size fp32 step per mode."""
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    ok = True
    for i, (name, xs, ws, spec, pads) in enumerate(precision_leaf_cases()):
        record, leaf_ok = precision_leaf(name, xs, ws, spec, pads, seed=900 + i)
        emit(phase="precision", part="a: leaf", **record)
        ok = ok and leaf_ok
        torch.cuda.empty_cache()
    emit(phase="precision", part="a: leaves", seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("precision (a): a leaf missed its bound, kept a flag or moved "
                             "'highest' off the TF32-off call; see above")

    # (b) the card against the CPU at the small size, trained weights, a rendered scene
    small = PipelineConfig(view_num=3, max_d=32, max_h=64, max_w=96)
    scene = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
    depths = {dev: precision_forward_rows(load_model(SPHERES, small, device=dev), scene, small,
                                          FP32_PRECISION_MODES) for dev in ("cuda", "cpu")}
    rows, ok = {}, True
    for m in FP32_PRECISION_MODES:
        d = (depths["cuda"][m] - depths["cpu"][m]).abs()
        mean_b, max_b = PRECISION_SMALL_BOUNDS[m]
        rows[m] = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                   "card_vs_card_highest_mean": float(
                       (depths["cuda"][m] - depths["cuda"]["highest"]).abs().mean()),
                   "bounds": [mean_b, max_b]}
        ok = (ok and bool(torch.isfinite(depths["cuda"][m]).all()) and float(d.mean()) <= mean_b
              and float(d.max()) <= max_b)
    emit(phase="precision", part="b: the card against the CPU", view_num=3, size=[64, 96],
         max_d=32, scene="render_multiplane_scene(seed=11, num_spheres=2)", modes=rows, ok=ok)
    if not ok:
        raise AssertionError("precision (b): a mode's forward on the card is not the CPU's")

    # (c) the flagship forward per mode, in turns
    cfg = PipelineConfig()
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    configs = {m: cfg.replace(fp32_precision=m) for m in FP32_PRECISION_MODES}
    outs, launches = {}, {}
    for m, c in configs.items():      # warm, and the launches of one forward per mode
        S.reset_launch_counts()
        out = multi_view_forward(model, images, cams, c)
        torch.cuda.synchronize()
        launches[m] = S.softargmin_cuda.launches
        outs[m] = out["depth"].cpu()
        del out
    seconds = {m: [] for m in configs}
    peaks = dict.fromkeys(configs, 0)
    for _ in range(PRECISION_ROUNDS):
        for m, c in configs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            multi_view_forward(model, images, cams, c)
            torch.cuda.synchronize()
            seconds[m].append(time.perf_counter() - t1)
            peaks[m] = max(peaks[m], torch.cuda.max_memory_allocated())
    profiles = {m: conv_kernel_profile(lambda c=c: multi_view_forward(model, images, cams, c))
                for m, c in configs.items()}
    rendered = train_batch(cfg, seed=21)
    gt = torch.from_numpy(rendered["depth_gt"])
    valid = gt > 0
    r_depths = precision_forward_rows(model, rendered, cfg, FP32_PRECISION_MODES)
    interval = float(cams[0, 0, 1, 3, 1])
    r_interval = float(rendered["cams"][0, 0, 1, 3, 1])
    rows, ok = {}, True
    for m in configs:
        moved, r_moved = (outs[m] - outs["highest"]).abs(), (r_depths[m] - r_depths["highest"]).abs()
        rows[m] = {"seconds_each": seconds[m], "seconds_median": float(np.median(seconds[m])),
                   "peak_memory_bytes": peaks[m], "softargmin_launches": launches[m],
                   "profile": profiles[m],
                   "noise_scene_vs_highest": {"mean_abs": float(moved.mean()),
                                              "max_abs": float(moved.max()),
                                              "mean_planes": float(moved.mean()) / interval},
                   "rendered_vs_highest": {"mean_abs": float(r_moved.mean()),
                                           "max_abs": float(r_moved.max()),
                                           "mean_planes": float(r_moved.mean()) / r_interval},
                   "rendered_mae_vs_ground_truth_planes":
                       float((r_depths[m] - gt).abs()[valid].mean()) / r_interval}
        ok = (ok and launches[m] == EXPECTED_LAUNCHES and bool(torch.isfinite(outs[m]).all())
              and bool(torch.isfinite(r_depths[m]).all()))
    emit(phase="precision", part="c: the flagship forward", view_num=cfg.view_num,
         size=[cfg.max_h, cfg.max_w], max_d=cfg.max_d, dtype=cfg.compute_dtype,
         cudnn_deterministic=True, rounds=PRECISION_ROUNDS, order=list(configs),
         expected_launches=EXPECTED_LAUNCHES, rendered_scene="render_multiplane_scene(seed=21, "
         "num_spheres=2) at the same size", modes=rows, ok=ok)
    del model, outs
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("precision (c): a mode's flagship forward launched the soft-argmin "
                             "other than 14 times or is not finite")

    # (d) one fp32 train step per mode at the train CLI's size
    tcfg = PipelineConfig(**TRAIN_SIZE)
    batch = train_batch(tcfg, seed=3)
    model = load_model(SPHERES, tcfg, device="cuda").requires_grad_(True)
    steps = {}
    for m in FP32_PRECISION_MODES:
        c = tcfg.replace(fp32_precision=m)
        loss_and_grads(model, batch, c, TrainConfig())       # warm
        torch.cuda.synchronize()
        S.reset_launch_counts()
        t1 = time.perf_counter()
        loss, _, grads = loss_and_grads(model, batch, c, TrainConfig())
        torch.cuda.synchronize()
        steps[m] = {"loss": float(loss), "seconds": time.perf_counter() - t1, "grads": grads,
                    "launches": (S.softargmin_cuda.launches, S.softargmin_backward_cuda.launches)}
    rows, ok = {}, True
    for m, st in steps.items():
        rows[m] = {"loss": st["loss"],
                   "loss_rel_vs_highest": abs(st["loss"] - steps["highest"]["loss"])
                   / abs(steps["highest"]["loss"]),
                   "grad_rel_vs_highest": grad_rel(st["grads"], steps["highest"]["grads"]),
                   "seconds": st["seconds"], "softargmin_launches": list(st["launches"])}
        ok = (ok and all(bool(torch.isfinite(g).all()) for g in st["grads"].values())
              and tuple(st["launches"]) == TRAIN_LAUNCHES[(False, 0.0)])
    emit(phase="precision", part="d: a train-size fp32 step", size=TRAIN_SIZE, modes=rows, ok=ok)
    torch.backends.cudnn.deterministic = False
    if not ok:
        raise AssertionError("precision (d): a mode's train step is not finite or launched "
                             "other soft-argmin counts")


# ---- the helpers phase ----

def helper_outputs(device: str) -> dict:
    """Every public helper that no path calls, on numpy-seeded inputs on `device`: {name:
    tensor or tuple of tensors}."""
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    _, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=1)
    cams = t(cams)
    img = t(rng.rand(2, 24, 32, 3))
    # a rotation, a shear and a perspective row: no sample lands on the pixel lattice
    hom = t(np.array([[0.97, 0.06, 0.83], [-0.04, 1.03, -0.61], [1.1e-3, -1.7e-3, 1.0]])[None]
            + 0.01 * rng.randn(2, 3, 3) * np.array([[1, 1, 10], [1, 1, 10], [0.01, 0.01, 0]]))
    x = t(rng.randn(2, 9, 10, 3))
    cfg = PipelineConfig(**HELPER_SIZE)
    model = init_model(cfg, seed=0, device=device)
    C = cfg.crm_base_filter
    att2d = aam.Attention2D(4, generator=torch.Generator().manual_seed(1)).to(device)
    feats = t(rng.rand(2, 1, 8, 8, 4))
    trailing = t(rng.randn(1, 8, 8, 8, C, 2))            # (B, D, h, w, C, P)
    ds, di = geometry.depth_range_from_cams(cams)
    return {
        "camera_center": camera_center(cams),
        "depth_range_from_cams": (ds, di),
        "homography_warp bilinear": geometry.homography_warp(img, hom, output_mask=True),
        "homography_warp nearest": geometry.homography_warp(img, hom, "nearest", output_mask=True),
        "build_cost_volume": build_cost_volume(feats[0], feats[1], cams[:, 0], cams[:, 1], cfg,
                                               ds, di),
        "build_cost_volume warp_ref": build_cost_volume(feats[0], feats[1], cams[:, 0],
                                                        cams[:, 1], cfg, ds, di, warp_ref=True),
        "attention_activation": aam.attention_activation(model.aam1_att, trailing),
        "attention_aggregate": aam.attention_aggregate(model.aam1_att, trailing),
        "attention_activation_2d": aam.attention_activation_2d(att2d, t(rng.randn(2, 10, 12, 4, 3))),
        "aam_aggregate": aam_aggregate(model, trailing, 2),
        "cost_volume_aggregation": cost_volume_aggregation(model, trailing, 1),
        "cost_volume_aggregation keepchannel": cost_volume_aggregation(model, trailing, 2,
                                                                       keepchannel=True),
        "l2_pool_same": L.l2_pool_same(x, 3, 2),
        "dense": L.dense(x, t(rng.randn(3, 5)), t(rng.randn(5))),
        "l2_normalize": L.l2_normalize(x),
        "split_separable_conv2d": L.split_separable_conv2d(
            x, t(rng.randn(1, 3, 3, 3)), t(rng.randn(4, 3, 1, 1)), t(rng.randn(3)),
            t(rng.randn(4)), rate=2),
    }


def phase_helpers():
    """The helpers on the card against the same calls on the CPU (HELPER_REL), dropout by
    its statistics, StageTimer, and device_trace's trace of a CUDA block."""
    t0 = time.perf_counter()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        got, want = helper_outputs("cuda"), helper_outputs("cpu")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    rows, masks, ok = {}, {}, True
    for name, ref in want.items():
        outs = got[name] if isinstance(ref, tuple) else (got[name],)
        for i, (a, b) in enumerate(zip(outs, ref if isinstance(ref, tuple) else (ref,))):
            a, key = a.cpu(), name if i == 0 else f"{name} [{i}]"
            if b.dtype == torch.bool:
                masks[name] = float((a == b).float().mean())
                ok = ok and masks[name] == 1.0
                continue
            err = float((a.float() - b.float()).abs().max())
            rows[key] = {"max_abs": err, "bound": HELPER_REL * max(1.0, float(b.abs().max()))}
            ok = (ok and a.shape == b.shape and bool(torch.isfinite(a).all())
                  and err <= rows[key]["bound"])
    # dropout: kept share against keep_prob, the kept values x / keep_prob, the same mask
    # from the same seed, the identity at inference
    keep = 0.7
    x = torch.rand(256, 256, device="cuda", generator=torch.Generator("cuda").manual_seed(3)) + 0.5
    drops = [L.dropout(x, keep, True, torch.Generator("cuda").manual_seed(4)) for _ in range(2)]
    share = float((drops[0] != 0).float().mean())
    sigma = math.sqrt(keep * (1 - keep) / x.numel())
    kept = drops[0] != 0
    dropout = {"kept_share": share, "keep_prob": keep, "bound": 5 * sigma,
               "kept_values_err": float((drops[0][kept] - x[kept] / keep).abs().max()),
               "same_seed_same_mask": bool(torch.equal(drops[0], drops[1])),
               "identity_at_inference": L.dropout(x, keep, training=False) is x}
    ok = (ok and abs(share - keep) <= 5 * sigma and dropout["kept_values_err"] <= 1e-6
          and dropout["same_seed_same_mask"] and dropout["identity_at_inference"])
    # StageTimer and device_trace around a CUDA block of HELPER_TRACE_BLOCKS matmuls, each
    # ending on the host. In a process that has launched many kernels the profiler drops
    # the first few kernel records of a session (a block of one matmul then showed none),
    # so the block is long enough that every trace still holds kernel events.
    timer = StageTimer()
    with tempfile.TemporaryDirectory() as logdir:
        for _ in range(2):
            with timer.stage("matmul"), device_trace(logdir):
                for _ in range(HELPER_TRACE_BLOCKS):
                    (x @ x).sum().item()
        with device_trace(""):
            pass
        kernels = []
        for path in sorted(glob.glob(os.path.join(logdir, "*.json"))):
            with open(path) as f:
                kernels.append(sum(1 for e in json.load(f)["traceEvents"]
                                   if e.get("cat") == "kernel"))
    summary = timer.summary()
    ok = ok and len(kernels) == 2 and min(kernels) > 0 and summary["matmul"]["count"] == 2
    emit(phase="helpers", card_against_cpu=rows, mask_agreement=masks, dropout=dropout,
         stage_timer=summary, device_trace={"blocks_per_trace": HELPER_TRACE_BLOCKS,
                                            "cuda_kernel_events_per_trace": kernels},
         seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("helpers: a helper on the card is not the CPU's")


# ---- the depth phase ----

def split_launch_record() -> dict:
    return {d: {"launches": fn.launches, "by_path": dict(fn.path_launches),
                "by_shape": shape_counts(fn.shape_launches)}
            for d, fn in (("partial", S.softargmin_partial_cuda),
                          ("backward_stats", S.softargmin_backward_stats_cuda),
                          ("forward", S.softargmin_cuda), ("backward", S.softargmin_backward_cuda))}


def split_bound_ms(shape, elem_bytes: int, kind: str, backward: bool):
    """Least time of one depth-split call: the partial forward reads the slice and writes
    the (3, B, h, w) fp32 triple; the stats-fed backward reads the slice, the (2, B, h, w)
    stats, the depth and the incoming gradient, and writes the slice's gradient; both
    read start and interval. Over HBM bandwidth, vs the operations over the fp32 peak."""
    B, D, h, w = shape
    if backward:
        nbytes = 2 * B * D * h * w * elem_bytes + 4 * B * h * w * 4 + 2 * B * 4
        flops = BWD_FLOPS_PER_ELEMENT
    else:
        nbytes = B * D * h * w * elem_bytes + 3 * B * h * w * 4 + 2 * B * 4
        flops = FLOPS_PER_ELEMENT
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = B * D * h * w * flops / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_inputs(shape, dtype, seed, transform=None):
    """A whole-D volume of twice the slice's planes, cut in two: the second half (offset
    D) as a rank's slice, and the stats and depth that merging both halves gives, with a
    seeded incoming gradient. transform "inf": every plane of the slice +inf at every 5th
    pixel (its triple is (-inf, 0, 0)); "misaligned": the slice 4 bytes off 16-byte
    alignment (the scalar path)."""
    B, D, h, w = shape
    full, ds, di = kernel_inputs((B, 2 * D, h, w), dtype, seed)
    if transform == "inf":
        full.view(B, 2 * D, h * w)[:, D:, ::5] = torch.inf
    halves = [full[:, :D].contiguous(), full[:, D:].contiguous()]
    triples = [S.softargmin_partial_torch(c, ds, di, k * D) for k, c in enumerate(halves)]
    m = torch.stack([t[0] for t in triples]).amax(dim=0)
    sums = sum(t[1:] * torch.exp(t[0] - S.finite_or_zero(m)) for t in triples)
    depth = (sums[1] / sums[0])[..., None].contiguous()
    stats = torch.stack([m, sums[0]]).contiguous()
    cost = misaligned_view(halves[1]) if transform == "misaligned" else halves[1]
    g = torch.randn(depth.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    return full, cost, ds, di, D, stats, depth, g


def split_kernel_cases():
    """(name, slice shape, dtype, path expected, transform). "D % chunk": a slice whose D
    neither the gradient kernel's chunk of planes nor the partial kernel's number of
    chunks divides; the train shape is the depth phase's (DEPTH_TRAIN_SHAPE, B = 2);
    "cluster of N": the partial kernel's chunks form a cluster of N blocks, 4 with B = 2
    and h*w no multiple of its tile (a tile spans both samples, the last is cut), 8 at
    the portable limit, 2 on the scalar path (checked in phase_kernel_split)."""
    f32, bf16 = torch.float32, torch.bfloat16
    native, tile = SPLIT_SHAPES
    return [("native slice", native, f32, "aligned", None), ("native slice bf16", native, bf16, "aligned", None),
            ("tile slice", tile, f32, "aligned", None), ("tile slice bf16", tile, bf16, "aligned", None),
            ("D % chunk slice", (1, 65, 120, 224), f32, "aligned", None),
            ("train slice, B=2", DEPTH_TRAIN_SHAPE, f32, "aligned", None),
            ("train slice, B=2 bf16", DEPTH_TRAIN_SHAPE, bf16, "aligned", None),
            ("cluster of 4, B=2, tile cut", (2, 128, 30, 36), f32, "aligned", None),
            ("cluster of 4, B=2, tile cut bf16", (2, 128, 30, 36), bf16, "aligned", None),
            ("cluster of 8", (1, 256, 8, 16), f32, "aligned", None),
            ("cluster of 2, scalar", (1, 64, 3, 33), f32, "scalar", None),
            ("all +inf slice", native, f32, "aligned", "inf"),
            ("misaligned slice", native, f32, "scalar", "misaligned")]


def phase_kernel_split() -> tuple[float, float]:
    """The partial forward against softargmin_partial_torch (the max to the bit, the sums
    at rtol 1e-5), and the merged triples against softargmin_torch of the whole volume;
    the stats-fed backward against its plain version (BWD_RTOL) and against autograd of
    softargmin_torch over the whole volume (the slice's planes), at SPLIT_SHAPES.
    Returns the largest difference of each kernel to its plain version."""
    worst = {"partial": 0.0, "backward_stats": 0.0}
    for i, (name, shape, dtype, path, transform) in enumerate(split_kernel_cases()):
        full, cost, ds, di, off, stats, depth, g = split_inputs(shape, dtype, 400 + i, transform)
        grid = S.gradient_grid(shape, dtype, path)
        pgrid = S.partial_grid(shape, dtype, path)
        tile_pixels = 32 * S.packet_pixels(dtype, path)
        if name.startswith("D % chunk") and (shape[1] % grid[2] == 0 or shape[1] % pgrid[1] == 0):
            raise AssertionError(f"split case '{name}': chunks of {grid[2]} planes or "
                                 f"{pgrid[1]} chunks divide D")
        if name.startswith("cluster of") and (
                pgrid[2] != int(name.split()[2].strip(",")) or
                ("tile cut" in name and shape[2] * shape[3] % tile_pixels == 0)):
            raise AssertionError(f"split case '{name}': the partial kernel's grid {pgrid} "
                                 f"(tiles of {tile_pixels} pixels) misses the case")
        before = (dict(S.softargmin_partial_cuda.path_launches),
                  dict(S.softargmin_backward_stats_cuda.path_launches))
        got = S.softargmin_partial_cuda(cost, ds, di, off)
        ref = S.softargmin_partial_torch(cost, ds, di, off)
        grad = S.softargmin_backward_stats_cuda(cost, ds, di, off, stats, depth, g).float()
        grad_ref = S.softargmin_backward_stats_torch(cost, ds, di, off, stats, depth, g).float()
        leaf = full.detach().clone().requires_grad_(True)
        S.softargmin_torch(leaf, ds, di).backward(g)
        torch.cuda.synchronize()
        took = [[p for p in S.PATHS if fn.path_launches[p] == b[p] + 1] for fn, b in
                zip((S.softargmin_partial_cuda, S.softargmin_backward_stats_cuda), before)]
        max_ok = torch.equal(got[0], ref[0])
        sums_ok, err = _within(got[1:], ref[1:], RTOL, 1e-6 * float(ref[1:].abs().max()))
        whole = S.softargmin_torch(full, ds, di)
        merged_ok, merged_err = _within(depth, whole, RTOL, ATOL)
        scale = float(grad_ref.abs().max())
        plain_ok, err_bwd = _within(grad, grad_ref, BWD_RTOL[dtype], 1e-6 * scale)
        auto_atol = 1e-5 * float(g.abs().max()) * float(S.sweep(2 * off, ds, di).abs().max())
        auto_ok, err_auto = _within(grad, leaf.grad[:, off:].float(), BWD_RTOL[dtype], auto_atol)
        inf_ok = True
        if transform == "inf":
            flat = got.view(3, shape[0], -1)[:, :, ::5]
            inf_ok = bool(torch.isneginf(flat[0]).all()) and bool((flat[1:] == 0).all())
        ok = (took == [[path], [path]] and max_ok and sums_ok and merged_ok and plain_ok
              and auto_ok and inf_ok)
        emit(phase="kernel", direction="depth split", case=name, shape=list(shape),
             dtype=str(dtype).split(".")[-1], offset=off, path=took, grid=list(grid),
             partial_grid=list(pgrid), cluster=pgrid[2], max_exact=max_ok,
             max_abs_err_partial=err, merged_vs_whole=merged_err, max_abs_err_backward=err_bwd,
             max_abs_err_backward_vs_autograd=err_auto, inf_slice_triple_ok=inf_ok, ok=ok)
        if not ok:
            raise AssertionError(f"depth-split kernel case '{name}' at {shape}: wrong path or "
                                 "values against the plain versions")
        worst["partial"] = max(worst["partial"], err)
        worst["backward_stats"] = max(worst["backward_stats"], err_bwd)
    return worst["partial"], worst["backward_stats"]


def phase_timing_split(kind):
    """Device times of the depth-split kernels beside their plain versions, bounds, an
    empty launch and torch.amax over D of the same volume (a yardstick that reads the same
    bytes), at SPLIT_SHAPES in fp32 and bf16 (the backward at the native slice, the shape
    training runs it at) and the partial forward at the train slice (DEPTH_TRAIN_SHAPE).
    Returns per kernel (ms, plain_ms, bound_ms, bound_by) of one depth=2 rank: the
    flagship forward's partial launches (depth_shapes(4, 2)) and a flagship train step's
    stats-fed backward launches (6 at the native slice)."""
    f32, bf16 = torch.float32, torch.bfloat16
    native, tile = SPLIT_SHAPES
    per_forward = depth_shapes(4, 2)
    totals = {"partial": dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0),
              "backward_stats": dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0)}
    bound_by = {"partial": "bytes", "backward_stats": "bytes"}
    train = DEPTH_TRAIN_SHAPE
    for backward, shape, dtype in [(False, native, f32), (False, tile, f32), (False, native, bf16),
                                   (False, tile, bf16), (False, train, f32), (False, train, bf16),
                                   (True, native, f32), (True, native, bf16), (True, tile, f32)]:
        elem = torch.tensor([], dtype=dtype).element_size()
        nbuf = max(2, math.ceil(200e6 / (math.prod(shape) * elem)))
        bufs = [split_inputs(shape, dtype, 500 + i)[1:] for i in range(nbuf)]
        copy_ms = None
        if backward:
            k_ms = device_ms(S.softargmin_backward_stats_cuda, bufs, 50)
            p_ms = device_ms(S.softargmin_backward_stats_torch, bufs, 20)
            copy_ms = device_ms(lambda c, *_: torch.empty_like(c).copy_(c), bufs, 50)
        else:
            bufs = [b[:4] for b in bufs]
            k_ms = device_ms(S.softargmin_partial_cuda, bufs, 50)
            p_ms = device_ms(S.softargmin_partial_torch, bufs, 20)
        grid = "gradient" if backward else "partial"
        e_ms = device_ms(lambda c, *_: S.empty_launch(c, grid=grid), bufs, 50)
        # a yardstick, not the same function: one PyTorch reduction over D that reads the
        # same bytes once and writes a plane
        amax_ms = device_ms(lambda c, *_: torch.amax(c, dim=1), bufs, 50)
        b_ms, b_by = split_bound_ms(shape, elem, kind, backward)
        name = "backward_stats" if backward else "partial"
        emit(phase="timing", what="softargmin_" + name, shape=list(shape),
             dtype=str(dtype).split(".")[-1], path="aligned",
             grid=list((S.gradient_grid if backward else S.partial_grid)(shape, dtype, "aligned")),
             kernel_ms=k_ms, plain_ms=p_ms, copy_ms=copy_ms, amax_ms=amax_ms, bound_ms=b_ms,
             bound_by=b_by,
             empty_launch_ms=e_ms, kernel_over_bound=k_ms / b_ms, buffers=nbuf, library_ms=None,
             library="none: no single PyTorch call computes a partial soft-argmin or its gradient")
        del bufs
        n = (6 if shape == native else 0) if backward else per_forward.get(shape, 0)
        if dtype == f32 and n:
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
                totals[name][key] += n * v
            bound_by[name] = b_by if b_by == "operations" else bound_by[name]
    return totals, bound_by


# ---- the int8 conv of act_quant="int8mxu" ----

def int8_pads(shape, stride, halo=False):
    """TF-SAME (lo, hi) per D, H, W of a k3 conv of a (B, D, H, W, Ci) input at `stride`;
    with `halo`, D already carries its halo planes and takes (0, 0), as a depth split's
    block does."""
    pads = [L._same_pads(n, 3, stride) for n in shape[1:4]]
    return [(0, 0)] + pads[1:] if halo else pads


def int8_inputs(shape, co, seed):
    """Seeded int8 operands over the whole range of the quantized ones, [-127, 127]: the
    input (B, D, H, W, Ci) and the kernel (Co, Ci, 3, 3, 3)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, shape, device="cuda", dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (co, shape[-1], 3, 3, 3), device="cuda", dtype=torch.int8,
                       generator=g)
    return xq, wq


def int8_kernel_cases():
    """(name, input shape, Co, stride, halo): every shape class of the flagship forward
    (INT8_MAIN_SHAPES, with Co = 1 and the AAM's B = 4), odd sizes, B = 2 (pair_batch's
    stage 1), Ci that takes 4-byte and byte loads, and a depth=2 split's blocks of the
    flagship volumes with their halo planes (D pads (0, 0))."""
    cases = [(f"main {'x'.join(map(str, k[:5]))}->{k[5]} s{k[6]}", k[:5], k[5], k[6], False)
             for k in INT8_MAIN_SHAPES]
    return cases + [("odd sizes s1", (2, 9, 7, 13, 16), 32, 1, False),
                    ("odd sizes s2", (1, 7, 9, 11, 8), 16, 2, False),
                    ("pair_batch B=2", (2, 128, 120, 224, 8), 16, 2, False),
                    ("Ci 12, 4-byte loads", (1, 8, 10, 12, 12), 24, 1, False),
                    ("Ci 6, byte loads", (1, 6, 5, 7, 6), 3, 1, False),
                    ("depth block s1", (1, 66, 120, 224, 8), 8, 1, True),
                    ("depth block s2", (1, 65, 60, 112, 16), 32, 2, True),
                    ("depth block AAM B=4", (4, 66, 120, 224, 8), 16, 1, True)]


def phase_kernel_int8() -> float:
    """The int8 conv kernel against conv3d_int8_torch (a float64 conv3d of the integer
    values, exact) to the bit, in each output kind: the int32 sums and the fp32 and bf16
    outputs scaled by INT8_SCALE. Each case's plan (ops.int8_conv.plan) is first checked
    by the C side (launch_plan: it refuses what it cannot take) and its line names the
    path it took and the plan; where a tensor map describes the input, the other ring
    path, forced, is held to the int32 sums as well (those launches count on their path
    but no main path runs here). Returns the largest difference (0 when all agree)."""
    worst, ok = 0.0, True
    scale = torch.tensor(INT8_SCALE, device="cuda")
    for i, (name, shape, co, stride, halo) in enumerate(int8_kernel_cases()):
        xq, wq = int8_inputs(shape, co, seed=700 + i)
        pads = int8_pads(shape, stride, halo)
        acc = I8.conv3d_int8_torch(xq, wq, stride, pads)
        chosen = I8.launch_plan(shape, co, stride, pads, torch.float32)
        before = I8.conv3d_int8_cuda.launches
        before_path = I8.conv3d_int8_cuda.path_launches[chosen["path"]]
        outputs = {}
        for out_dtype in (None, torch.float32, torch.bfloat16):
            sc = None if out_dtype is None else scale
            got = I8.conv3d_int8_cuda(xq, wq, stride, pads, sc, out_dtype)
            torch.cuda.synchronize()
            want = I8.epilogue(acc, sc, out_dtype)
            err = float((got.double() - want.double()).abs().max())
            outputs[str(out_dtype or torch.int32).split(".")[-1]] = {
                "equal": bool(torch.equal(got, want)), "max_abs_err": err}
            worst = max(worst, err)
            del got, want
        launched = I8.conv3d_int8_cuda.launches - before
        on_path = I8.conv3d_int8_cuda.path_launches[chosen["path"]] - before_path
        others = {}
        for path in ("ring", "ring_cluster"):
            if path == chosen["path"] or I8.map_layout(shape) is None:
                continue
            forced = I8.launch_plan(shape, co, stride, pads, None, path=path)
            got = I8.launch(xq, wq, stride, pads, None, None, forced)
            torch.cuda.synchronize()
            err = float((got.double() - acc.double()).abs().max())
            others[path] = {"equal": bool(torch.equal(got, acc)), "max_abs_err": err,
                            "plan": {k: forced[k] for k in I8.PLAN_FIELDS}}
            worst = max(worst, err)
            del got
        case_ok = (all(o["equal"] for o in outputs.values()) and launched == 3 and on_path == 3
                   and all(o["equal"] for o in others.values()))
        emit(phase="kernel", kernel="conv3d_int8", case=name, input=list(shape), co=co,
             stride=stride, pads=pads, output=list(acc.shape), path=chosen["path"],
             plan=chosen, largest_sum=int(acc.abs().max()), outputs=outputs,
             other_paths_int32=others, launches=launched, ok=case_ok)
        ok = ok and case_ok
        del xq, wq, acc
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the int8 conv kernel disagrees with its plain version; see above")
    return worst


def int8_bound_ms(shape, co, stride, out_bytes: int, kind: str):
    """Least time of one int8 conv: the int8 input and weights read once, the output
    written once (out_bytes a value) and the scale read, over HBM bandwidth, vs 2 * 27 * Ci
    operations per output value over the int8 tensor-core peak."""
    B, D, H, W, Ci = shape
    _, Do, Ho, Wo, _ = I8.output_shape(shape, co, stride, int8_pads(shape, stride))
    outputs = B * Do * Ho * Wo * co
    nbytes = B * D * H * W * Ci + co * Ci * 27 + outputs * out_bytes + 4
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = 2 * 27 * Ci * outputs / INT8_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing_int8(kind):
    """Device times of the int8 conv kernel at every shape class of the flagship forward
    (INT8_MAIN_SHAPES), with fp32 and bf16 output, beside its bound, an empty launch of the
    plan's grid (the same blocks, shared memory and cluster), the plain version's time
    (fp32) and, as a yardstick, cuDNN's float conv of the same shape in the output's dtype
    (the port's float conv, layers._padded_conv, with deterministic algorithms and TF32
    off): the conv that the int8 route replaces, not the same function. In fp32 the other
    ring path (ring against ring_cluster, forced) is timed beside the planner's choice:
    the times that set the planner's rule. The library call: cuDNN's float conv with TF32
    allowed on the int8 values held as float32 (padded beforehand, one F.conv3d) computes
    the same sums wherever they stay below 2^24 (TF32 holds every int8 value, and fp32 every
    product and such a sum), provided its algorithm multiplies the values as they are: its
    sums are held to the kernel's to the bit on the first buffer, and the largest sum is
    reported. Returns the kernel, plain, bound, library and cuDNN ms of one fp32 flagship
    forward, and what bounds most of that forward's bound (a class of its own may be bound
    by the other)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    totals = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms", "cudnn_float_ms",
                            "empty_launch_ms"), 0.0)
    library_equal = True
    bound_ms_by = {"bytes": 0.0, "operations": 0.0}
    scale = torch.tensor(INT8_SCALE, device="cuda")
    for key, n in INT8_MAIN_SHAPES.items():
        shape, co, stride = key[:5], key[5], key[6]
        pads = int8_pads(shape, stride)
        nbuf = max(2, math.ceil(200e6 / math.prod(shape)))
        bufs = [int8_inputs(shape, co, seed=800 + i) for i in range(nbuf)]
        for out_dtype in (torch.float32, torch.bfloat16):
            chosen = I8.launch_plan(shape, co, stride, pads, out_dtype)
            k_ms = device_ms(lambda x, w: I8.conv3d_int8_cuda(x, w, stride, pads, scale, out_dtype),
                             bufs, 20)
            e_ms = device_ms(lambda x, w: I8.empty_launch(x, co, stride, pads, out_dtype, chosen),
                             bufs, 50)
            other = None
            if out_dtype == torch.float32:
                path = "ring" if chosen["path"] == "ring_cluster" else "ring_cluster"
                forced = I8.launch_plan(shape, co, stride, pads, out_dtype, path=path)
                other = {"path": path, "plan": {k: forced[k] for k in I8.PLAN_FIELDS},
                         "kernel_ms": device_ms(lambda x, w: I8.launch(x, w, stride, pads, scale,
                                                                       out_dtype, forced), bufs, 20)}
            floats = [(x.to(out_dtype), w.to(out_dtype)) for x, w in bufs[:2]]
            c_ms = device_ms(lambda x, w: L._padded_conv(x, w, None, stride, 1, pads), floats, 20)
            del floats
            p_ms = lib_ms = lib = None
            if out_dtype == torch.float32:
                p_ms = device_ms(lambda x, w: I8.conv3d_int8_torch(x, w, stride, pads, scale,
                                                                   out_dtype), bufs[:1], 2)
                flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
                held = [(torch.nn.functional.pad(x.movedim(-1, 1).float(), flat), w.float())
                        for x, w in bufs]
                with fp32_passes.tf32(True):
                    sums = torch.nn.functional.conv3d(*held[0], stride=stride).movedim(1, -1)
                    lib_ms = device_ms(lambda x, w: torch.nn.functional.conv3d(x, w, stride=stride),
                                       held, 20)
                acc = I8.conv3d_int8_cuda(*bufs[0], stride, pads)
                largest = int(acc.abs().max())
                lib = {"equal": bool(torch.equal(sums, acc.float())) and largest < 2 ** 24,
                       "largest_sum": largest}
                library_equal = library_equal and lib["equal"]
                del held, sums, acc
            b_ms, b_by = int8_bound_ms(shape, co, stride, out_dtype.itemsize, kind)
            emit(phase="timing", what="conv3d_int8", input=list(shape), co=co, stride=stride,
                 out_dtype=str(out_dtype).split(".")[-1], launches_per_forward=n,
                 path=chosen["path"], plan=chosen, kernel_ms=k_ms, empty_launch_ms=e_ms,
                 other_path=other, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                 kernel_over_bound=k_ms / b_ms, cudnn_float_ms=c_ms, buffers=nbuf,
                 library_ms=lib_ms, library_sums=lib,
                 library="cuDNN's conv, TF32 allowed, on the int8 values held as float32 "
                         "(fp32 runs only); cudnn_float_ms is the float conv of the same shape "
                         "that the int8 route replaces, TF32 off")
            if out_dtype == torch.float32:
                for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms), ("cudnn_float_ms", c_ms),
                             ("empty_launch_ms", e_ms)):
                    totals[k] += n * v
                bound_ms_by[b_by] += n * b_ms
        del bufs
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    totals["library_sums_equal"] = library_equal
    emit(phase="timing", what="conv3d_int8 per fp32 flagship forward", **totals)
    return totals, max(bound_ms_by, key=bound_ms_by.get)


def int8_expected_paths() -> dict:
    """Launches per path of one flagship int8mxu forward, from the planner at the card's
    limits (every INT8_MAIN_SHAPES class at its count)."""
    paths = dict.fromkeys(I8.PATHS, 0)
    for key, n in INT8_MAIN_SHAPES.items():
        shape, co, stride = key[:5], key[5], key[6]
        paths[I8.launch_plan(shape, co, stride, int8_pads(shape, stride))["path"]] += n
    return paths


def conv2d_bound_ms(x_shape, w_shape, out_shape, stride, rate, pads, kind: str):
    """Least time of one fp32 conv2d: the input elements some tap reads (a strided 1x1 conv
    reads a fraction of x), the weights and the output moved once over HBM bandwidth vs
    2 * K FLOPs per output value over the fp32 peak."""
    def touched(n, out, k, lo):
        return len({o * stride - lo + t * rate for o in range(out) for t in range(k)}
                   & set(range(n)))

    rows = touched(x_shape[1], out_shape[1], w_shape[2], pads[0][0])
    cols = touched(x_shape[2], out_shape[2], w_shape[3], pads[1][0])
    nbytes = 4 * (x_shape[0] * rows * cols * x_shape[3] + math.prod(w_shape)
                  + math.prod(out_shape))
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = 2 * math.prod(w_shape[1:]) * math.prod(out_shape) / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_classes(launcher, expected: int, views: int) -> dict:
    """{shape key: launches} of one N-view forward at 480x896, D=128 with the spheres weights,
    from the shape counter of `launcher` (conv2d_fp32_cuda, conv3d_fp32_cuda or
    conv3d_transpose_fp32_cuda), whose launches must be `expected`."""
    cfg = PipelineConfig(view_num=views)
    images, cams = synthetic_scene(view_num=views, H=cfg.max_h, W=cfg.max_w, D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    C2.reset_launch_counts()
    C3.reset_launch_counts()
    CT.reset_launch_counts()
    with torch.no_grad():
        multi_view_forward(model, images, cams, cfg)
    torch.cuda.synchronize()
    classes = dict(launcher.shape_launches)
    if launcher.launches != expected:
        raise AssertionError(f"{views}-view forward: {launcher.launches} launches of "
                             f"{launcher.__name__}, expected {expected}")
    del model
    torch.cuda.empty_cache()
    return classes


def phase_conv2d(kind) -> dict:
    """The fp32 conv2d kernel at every class of the 5-view (served) and 8-view (eval)
    forwards at 480x896: held to the float64 product (conv_exact on the padded operands)
    within conv2d_kernel_bound(K) of max sum |a||b|, the same bits on a second call, and
    timed beside its bound, the call with its weight packing, the plain version (the route's
    call before the kernel: F.pad where the pads differ, then cuDNN with TF32 off) and the
    library call (one cuDNN conv, TF32 off, on pre-padded channels-last operands, default
    algorithms as the parent's forward runs them; its error beside the kernel's). Returns
    the per-forward sums for each view count."""
    totals, ok = {}, True
    for views in CONV2D_VIEWS:
        classes = kernel_classes(C2.conv2d_fp32_cuda, conv2d_forward_launches(views), views)
        tot = dict.fromkeys(("kernel_ms", "call_ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
        ordered = sorted(classes.items(), key=lambda kv: -math.prod(kv[0][0]))
        for i, ((xs, ws, stride, rate, pads), n) in enumerate(ordered):
            out_shape = C2.output_shape(xs, ws, stride, rate, pads)
            per = 4 * (math.prod(xs) + math.prod(out_shape))
            nbuf = max(2, min(64, math.ceil(200e6 / per)))
            g = torch.Generator(device="cuda").manual_seed(1700 + i)
            bufs = [(torch.randn(xs, device="cuda", generator=g),
                     torch.randn(ws, device="cuda", generator=g) / math.sqrt(math.prod(ws[1:])))
                    for _ in range(nbuf)]
            x, w = bufs[0]
            p = C2.plan(xs[-1], ws[0])
            got = C2.conv2d_fp32_cuda(x, w, None, stride, rate, pads)
            again = C2.conv2d_fp32_cuda(x, w, None, stride, rate, pads)
            flat = [q for lo, hi in reversed(pads) for q in (lo, hi)]
            xc = torch.nn.functional.pad(x.movedim(-1, 1), flat)
            spec = fp32_passes.ConvSpec.of(2, stride, 0, rate)
            scale = float(fp32_passes.conv_exact(xc, w, spec, magnitude=True)["forward"].max())
            exact = fp32_passes.conv_exact(xc, w, spec)["forward"].movedim(1, -1)
            with fp32_passes.tf32(False):
                lib_out = torch.nn.functional.conv2d(xc, w, stride=stride, dilation=rate)
            err = float((got.double() - exact).abs().max()) / scale
            lib_err = float((lib_out.movedim(1, -1).double() - exact).abs().max()) / scale
            del exact, lib_out
            bound = conv2d_kernel_bound(math.prod(ws[1:]))
            same_bits = bool(torch.equal(got, again))
            held = err <= bound and same_bits
            ok = ok and held
            packed = [(b[0], C2.packed_weights(b[1])) for b in bufs]
            k_ms = device_ms(lambda x_, wp_: C2._launch(x_, wp_, None, ws, stride, rate, pads, p),
                             packed, 20)
            c_ms = device_ms(lambda x_, w_: C2.conv2d_fp32_cuda(x_, w_, None, stride, rate, pads),
                             bufs, 20)
            with torch.no_grad():
                pl_ms = device_ms(lambda x_, w_: C2.conv2d_fp32_torch(x_, w_, None, stride, rate,
                                                                      pads), bufs, 10)
            padded = [(torch.nn.functional.pad(b[0].movedim(-1, 1), flat), b[1]) for b in bufs[:2]]
            with fp32_passes.tf32(False):
                lib_ms = device_ms(lambda x_, w_: torch.nn.functional.conv2d(
                    x_, w_, stride=stride, dilation=rate), padded, 10)
            b_ms, b_by = conv2d_bound_ms(xs, ws, out_shape, stride, rate, pads, kind)
            emit(phase="conv2d", views=views, x=list(xs), w=list(ws), stride=stride, rate=rate,
                 pads=[list(q) for q in pads], launches_per_forward=n, tile=p["tile"],
                 path=p["path"], kernel_ms=k_ms, call_ms=c_ms, bound_ms=b_ms, bound_by=b_by,
                 kernel_over_bound=k_ms / b_ms, plain_ms=pl_ms, library_ms=lib_ms,
                 error_over_max_sum_abs=err, library_error=lib_err, error_bound=bound,
                 same_bits=same_bits, ok=held)
            for key, v in (("kernel_ms", k_ms), ("call_ms", c_ms), ("plain_ms", pl_ms),
                           ("library_ms", lib_ms), ("bound_ms", b_ms)):
                tot[key] += n * v
            del bufs, packed, padded, got, again, xc
            torch.cuda.empty_cache()
        emit(phase="conv2d", what=f"per {views}-view forward", classes=len(classes),
             launches=sum(classes.values()), **tot)
        totals[views] = tot
    if not ok:
        raise AssertionError("conv2d: a class missed its bound or changed bits between calls")
    return totals


def conv3d_bound_ms(x_shape, w_shape, out_shape, kind: str):
    """Least time of one fp32 3x3x3 conv3d: the input (every element is some tap's at
    stride 1 and 2), the weights and the output moved once over HBM bandwidth vs 2 * 27 * Ci
    FLOPs per output value over the fp32 peak."""
    nbytes = 4 * (math.prod(x_shape) + math.prod(w_shape) + math.prod(out_shape))
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = 2 * math.prod(w_shape[1:]) * math.prod(out_shape) / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_conv3d(kind) -> dict:
    """The fp32 conv3d kernel at every class of the 5-view (served) and 8-view (eval)
    forwards at 480x896, D=128: held to the float64 product (conv_exact on the padded
    operands) within conv2d_kernel_bound(27 Ci) of max sum |a||b|, the same bits on a second
    call, and timed beside its bound, the call through the wrapper, the plain version (the
    route's call before the kernel: F.pad where the pads differ, then cuDNN with TF32 off)
    and the library call (one cuDNN conv3d, TF32 off, on pre-padded channels-last
    operands, default algorithms as the parent's forward ran them; its error beside the
    kernel's). Returns the per-forward sums for each view count."""
    totals, ok = {}, True
    for views in CONV2D_VIEWS:
        classes = kernel_classes(C3.conv3d_fp32_cuda, conv3d_forward_launches(views), views)
        tot = dict.fromkeys(("kernel_ms", "call_ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
        ordered = sorted(classes.items(), key=lambda kv: -math.prod(kv[0][0]) * kv[0][1][0])
        for i, ((xs, ws, stride, pads), n) in enumerate(ordered):
            out_shape = C3.output_shape(xs, ws, stride, pads)
            per = 4 * (math.prod(xs) + math.prod(out_shape))
            nbuf = max(2, min(64, math.ceil(200e6 / per)))
            g = torch.Generator(device="cuda").manual_seed(2000 + i)
            bufs = [(torch.randn(xs, device="cuda", generator=g),
                     torch.randn(ws, device="cuda", generator=g) / math.sqrt(math.prod(ws[1:])))
                    for _ in range(nbuf)]
            x, w = bufs[0]
            p = C3.plan(xs[-1], ws[0], stride)
            got = C3.conv3d_fp32_cuda(x, w, None, stride, 1, pads)
            again = C3.conv3d_fp32_cuda(x, w, None, stride, 1, pads)
            flat = [q for lo, hi in reversed(pads) for q in (lo, hi)]
            xc = torch.nn.functional.pad(x.movedim(-1, 1), flat)
            spec = fp32_passes.ConvSpec.of(3, stride, 0, 1)
            scale = float(fp32_passes.conv_exact(xc, w, spec, magnitude=True)["forward"].max())
            exact = fp32_passes.conv_exact(xc, w, spec)["forward"].movedim(1, -1)
            with fp32_passes.tf32(False):
                lib_out = torch.nn.functional.conv3d(xc, w, stride=stride)
            err = float((got.double() - exact).abs().max()) / scale
            lib_err = float((lib_out.movedim(1, -1).double() - exact).abs().max()) / scale
            del exact, lib_out
            bound = conv2d_kernel_bound(math.prod(ws[1:]))
            same_bits = bool(torch.equal(got, again))
            held = err <= bound and same_bits
            ok = ok and held
            k_ms = device_ms(lambda x_, w_: C3._launch(x_, w_, None, stride, pads, p), bufs, 20)
            c_ms = device_ms(lambda x_, w_: C3.conv3d_fp32_cuda(x_, w_, None, stride, 1, pads),
                             bufs, 20)
            with torch.no_grad():
                pl_ms = device_ms(lambda x_, w_: C3.conv3d_fp32_torch(x_, w_, None, stride, 1,
                                                                      pads), bufs, 10)
            padded = [(torch.nn.functional.pad(b[0].movedim(-1, 1), flat), b[1]) for b in bufs[:2]]
            with fp32_passes.tf32(False):
                lib_ms = device_ms(lambda x_, w_: torch.nn.functional.conv3d(
                    x_, w_, stride=stride), padded, 10)
            b_ms, b_by = conv3d_bound_ms(xs, ws, out_shape, kind)
            emit(phase="conv3d", views=views, x=list(xs), w=list(ws), stride=stride,
                 pads=[list(q) for q in pads], launches_per_forward=n, plan=p,
                 kernel_ms=k_ms, call_ms=c_ms, bound_ms=b_ms, bound_by=b_by,
                 kernel_over_bound=k_ms / b_ms, plain_ms=pl_ms, library_ms=lib_ms,
                 error_over_max_sum_abs=err, library_error=lib_err, error_bound=bound,
                 same_bits=same_bits, ok=held)
            for key, v in (("kernel_ms", k_ms), ("call_ms", c_ms), ("plain_ms", pl_ms),
                           ("library_ms", lib_ms), ("bound_ms", b_ms)):
                tot[key] += n * v
            del bufs, padded, got, again, xc
            torch.cuda.empty_cache()
        emit(phase="conv3d", what=f"per {views}-view forward", classes=len(classes),
             launches=sum(classes.values()), **tot)
        totals[views] = tot
    if not ok:
        raise AssertionError("conv3d: a class missed its bound or changed bits between calls")
    return totals


def deconv3d_bound_ms(x_shape, w_shape, out_shape, kind: str):
    """Least time of one fp32 3x3x3 stride-2 transposed conv3d that writes its cropped output:
    the input, the weights and the cropped output moved once over HBM bandwidth vs 2 * 27 *
    Ci * Co FLOPs per input cell (eight outputs) over the fp32 peak."""
    nbytes = 4 * (math.prod(x_shape) + math.prod(w_shape) + math.prod(out_shape))
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    cells = math.prod(out_shape[1:-1]) // 8 * out_shape[0]
    t_ops = 2 * 27 * w_shape[0] * w_shape[1] * cells / FP32_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_deconv3d(kind) -> dict:
    """The fp32 transposed conv3d kernel at every class of the 5-view (served) and 8-view
    (eval) forwards at 480x896, D=128 (recorded from each forward's shape counter): held to
    the float64 product (conv_exact of the transposed conv, cropped) within
    conv2d_kernel_bound(8 Ci) of max sum |a||b|, the same bits on a second call, and timed
    beside its bound, the call through the wrapper, the plain version (the route's call
    before the kernel: pass_conv_transpose in "highest", then the crop's view) and, as the
    yardstick, that call's cuDNN transposed conv alone (TF32 off: convolveNd_dgrad with its
    setTensor5d fill; its error beside the kernel's). Returns the per-forward sums for each
    view count."""
    totals, ok = {}, True
    spec = fp32_passes.ConvSpec.of(3, 2, transposed=True)
    for views in CONV2D_VIEWS:
        classes = kernel_classes(CT.conv3d_transpose_fp32_cuda,
                                 deconv3d_forward_launches(views), views)
        tot = dict.fromkeys(("kernel_ms", "call_ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
        ordered = sorted(classes.items(), key=lambda kv: -math.prod(kv[0][0]) * kv[0][1][1])
        for i, ((xs, ws, begs), n) in enumerate(ordered):
            out_shape = CT.output_shape(xs, ws, begs)
            per = 4 * (math.prod(xs) + math.prod(out_shape))
            nbuf = max(2, min(64, math.ceil(200e6 / per)))
            g = torch.Generator(device="cuda").manual_seed(2400 + i)
            bufs = [(torch.randn(xs, device="cuda", generator=g),
                     torch.randn(ws, device="cuda", generator=g) / math.sqrt(8 * ws[0]))
                    for _ in range(nbuf)]
            x, w = bufs[0]
            p = CT.plan(xs[-1], ws[1])
            got = CT.conv3d_transpose_fp32_cuda(x, w, begs)
            again = CT.conv3d_transpose_fp32_cuda(x, w, begs)
            crop = (slice(None), slice(None)) + tuple(slice(b, 2 * m)
                                                      for m, b in zip(xs[1:4], begs))
            xc = x.movedim(-1, 1)
            scale = float(fp32_passes.conv_exact(xc, w, spec, magnitude=True)["forward"][crop]
                          .max())
            exact = fp32_passes.conv_exact(xc, w, spec)["forward"][crop].movedim(1, -1)
            with fp32_passes.tf32(False):
                lib_out = torch.nn.functional.conv_transpose3d(xc, w, stride=2)[crop]
            err = float((got.double() - exact).abs().max()) / scale
            lib_err = float((lib_out.movedim(1, -1).double() - exact).abs().max()) / scale
            del exact, lib_out
            bound = conv2d_kernel_bound(8 * ws[0])
            same_bits = bool(torch.equal(got, again))
            held = err <= bound and same_bits
            ok = ok and held
            k_ms = device_ms(lambda x_, w_: CT._launch(x_, w_, begs, p), bufs, 20)
            c_ms = device_ms(lambda x_, w_: CT.conv3d_transpose_fp32_cuda(x_, w_, begs),
                             bufs, 20)
            with torch.no_grad():
                pl_ms = device_ms(lambda x_, w_: CT.conv3d_transpose_fp32_torch(x_, w_, begs),
                                  bufs, 10)
            with fp32_passes.tf32(False):
                lib_ms = device_ms(lambda x_, w_: torch.nn.functional.conv_transpose3d(
                    x_.movedim(-1, 1), w_, stride=2), bufs, 10)
            b_ms, b_by = deconv3d_bound_ms(xs, ws, out_shape, kind)
            emit(phase="deconv3d", views=views, x=list(xs), w=list(ws), begs=list(begs),
                 launches_per_forward=n, plan=p, kernel_ms=k_ms, call_ms=c_ms, bound_ms=b_ms,
                 bound_by=b_by, kernel_over_bound=k_ms / b_ms, plain_ms=pl_ms,
                 library_ms=lib_ms, error_over_max_sum_abs=err, library_error=lib_err,
                 error_bound=bound, same_bits=same_bits, ok=held)
            for key, v in (("kernel_ms", k_ms), ("call_ms", c_ms), ("plain_ms", pl_ms),
                           ("library_ms", lib_ms), ("bound_ms", b_ms)):
                tot[key] += n * v
            del bufs, got, again, xc
            torch.cuda.empty_cache()
        emit(phase="deconv3d", what=f"per {views}-view forward", classes=len(classes),
             launches=sum(classes.values()), kernel_over_bound=tot["kernel_ms"] / tot["bound_ms"],
             **tot)
        totals[views] = tot
    if not ok:
        raise AssertionError("deconv3d: a class missed its bound or changed bits between calls")
    return totals


def sweep_bound_ms(key, kind: str):
    """Least time of one plane-sweep sample of class `key` (image shape, P, dtype, kind,
    nearest channels): the coordinates read once (two fp32 a sample), the source map read
    once, every output and the mask (a byte a sample) written once, over HBM bandwidth."""
    (B, H, W, C), P_, dtype, what, nearest = key
    elem = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    out_channels = (C if what != "nearest" else 0) + (nearest[1] if nearest else 0)
    nbytes = B * P_ * (8 + out_channels * elem + 1) + B * H * W * C * elem
    return nbytes / HBM_BYTES_PER_S[kind] * 1e3


def sweep_classes(views: int) -> dict:
    """{class key: (launches, (image, x, y, bilinear, nearest channels))} of one N-view
    forward at 480x896, D=128 with the spheres weights: the classes from the kernel's shape
    counter (whose launches must be sweep_forward_launches(views)), each with the inputs of
    its first launch in the forward, copied."""
    cfg = PipelineConfig(view_num=views)
    images, cams = synthetic_scene(view_num=views, H=cfg.max_h, W=cfg.max_w, D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    first, launch = {}, PS._launch

    def record(image, x, y, bilinear, nearest, p):
        key = (tuple(image.shape), x.shape[1], str(image.dtype).replace("torch.", ""),
               p["kind"], nearest)
        if key not in first:
            sl = None if nearest is None else slice(nearest[0], nearest[0] + nearest[1])
            first[key] = (image.clone(), x.clone(), y.clone(), bilinear, sl)
        return launch(image, x, y, bilinear, nearest, p)

    PS.reset_launch_counts()
    PS._launch = record
    try:
        with torch.no_grad():
            multi_view_forward(model, images, cams, cfg)
        torch.cuda.synchronize()
    finally:
        PS._launch = launch
    if PS.plane_sweep_cuda.launches != sweep_forward_launches(views):
        raise AssertionError(f"{views}-view forward: {PS.plane_sweep_cuda.launches} plane-sweep "
                             f"launches, expected {sweep_forward_launches(views)}")
    classes = {k: (n, first[k]) for k, n in PS.plane_sweep_cuda.shape_launches.items()}
    del model
    torch.cuda.empty_cache()
    return classes


def same_bits(got, want) -> bool:
    """Whether two samples' outputs (tuples with None where not asked for) agree bit for bit."""
    def bits(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t.view(
            {4: torch.int32, 2: torch.int16}[t.element_size()])

    return all((a is None and b is None) or (a is not None and b is not None and a.shape == b.shape
                                             and torch.equal(bits(a), bits(b)))
               for a, b in zip(got, want))


def phase_sweep(kind) -> dict:
    """The plane-sweep sampler at every class of the 5-view (served) and 8-view (eval)
    forwards at 480x896, D=128, on the inputs of the class's first launch in the forward:
    held to the plain version (ops.plane_sweep.sample_torch, the route's chain before the
    kernel) to the bit in float32 and with the image in bfloat16, the same bits on a second
    call, and timed beside its bound and the plain version. Returns the per-forward sums for
    each view count."""
    totals, ok = {}, True
    for views in CONV2D_VIEWS:
        classes = sweep_classes(views)
        tot = dict.fromkeys(("kernel_ms", "call_ms", "plain_ms", "bound_ms"), 0.0)
        for key, (n, (image, x, y, bilinear, sl)) in sorted(classes.items(), key=lambda kv: -kv[0][1]):
            nearest = PS.nearest_range(sl, image.shape[-1])
            p = PS.plan(image.shape[-1], image.dtype, bilinear, nearest)
            got = PS.plane_sweep_cuda(image, x, y, bilinear, sl)
            again = PS.plane_sweep_cuda(image, x, y, bilinear, sl)
            want = PS.sample_torch(image, x, y, bilinear, sl)
            held = same_bits(got, want) and same_bits(again, got)
            del got, again, want
            half = image.bfloat16()
            bf16_held = same_bits(PS.plane_sweep_cuda(half, x, y, bilinear, sl),
                                  PS.sample_torch(half, x, y, bilinear, sl))
            ok = ok and held and bf16_held
            k_ms = device_ms(lambda *a: PS._launch(*a, bilinear, nearest, p), [(image, x, y)], 20)
            c_ms = device_ms(lambda *a: PS.plane_sweep_cuda(*a, bilinear, sl), [(image, x, y)], 20)
            with torch.no_grad():
                pl_ms = device_ms(lambda *a: PS.sample_torch(*a, bilinear, sl), [(image, x, y)], 5)
            b_ms = sweep_bound_ms(key, kind)
            emit(phase="sweep", views=views, image=list(key[0]), samples=key[1], dtype=key[2],
                 kind=key[3], nearest=key[4], launches_per_forward=n, path=p["path"],
                 valid_share=float(PS.sample_torch(image, x, y, False, slice(0, 1))[2].float().mean()),
                 kernel_ms=k_ms, call_ms=c_ms, bound_ms=b_ms, kernel_over_bound=k_ms / b_ms,
                 plain_ms=pl_ms, plain_over_kernel=pl_ms / k_ms, same_bits=held,
                 bf16_same_bits=bf16_held, ok=held and bf16_held)
            for name, v in (("kernel_ms", k_ms), ("call_ms", c_ms), ("plain_ms", pl_ms),
                            ("bound_ms", b_ms)):
                tot[name] += n * v
            del half
            torch.cuda.empty_cache()
        emit(phase="sweep", what=f"per {views}-view forward", classes=len(classes),
             launches=sum(n for n, _ in classes.values()), **tot,
             kernel_over_bound=tot["kernel_ms"] / tot["bound_ms"])
        totals[views] = tot
        del classes
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("sweep: a class differs from the plain version or between calls")
    return totals


def phase_forward_int8(model, images, cams, cfg) -> tuple[int, dict]:
    """The flagship forward under act_quant="int8mxu" (deterministic cuDNN): every qin conv
    on the int8 kernel, counted from 0 over this forward by shape (INT8_MAIN_SHAPES) and by
    path (as the planner says for each class: none generic), the soft-argmin
    kernel's launches as in the fp32 forward (MAIN_SHAPES), shapes and finiteness, seconds
    and peak memory of this first forward, and how far it moves the depth from the
    unquantized forward's (no bound: the noise images' softmax over D is flat, see
    phase_quant, which also times it in turns). Returns the int8 launches in total and by
    path."""
    mxu = cfg.replace(act_quant="int8mxu")
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    I8.reset_launch_counts()
    S.reset_launch_counts()
    C3.reset_launch_counts()
    CT.reset_launch_counts()
    t0 = time.perf_counter()
    out = multi_view_forward(model, images, cams, mxu)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = I8.conv3d_int8_cuda.launches
    conv3d_launches = C3.conv3d_fp32_cuda.launches
    deconv3d_launches = CT.conv3d_transpose_fp32_cuda.launches
    by_shape = dict(I8.conv3d_int8_cuda.shape_launches)
    by_path = dict(I8.conv3d_int8_cuda.path_launches)
    softargmin_by_shape = dict(S.softargmin_cuda.shape_launches)
    peak = torch.cuda.max_memory_allocated()
    B, N, H, W = 1, cfg.view_num, cfg.max_h, cfg.max_w
    h, w, D, P = H // 4, W // 4, cfg.max_d, N - 1
    shapes = {"depth": (B, h, w, 1), "depth_up": (B, H, W, 1), "depth_agg_initial": (B, h, w, 1),
              "prob_volume_agg": (B, D, h, w), "refined_prob_volumes": (P, B, D, h, w),
              "depth_views": (P, B, h, w, 1)}
    bad = [k for k, s in shapes.items() if tuple(out[k].shape) != s]
    nonfinite = [k for k in shapes if not bool(torch.isfinite(out[k]).all())]
    plain = multi_view_forward(model, images, cams, cfg)
    torch.backends.cudnn.deterministic = False
    interval = float(cams[0, 0, 1, 3, 1])
    moved = {k: {"mean_planes": float((out[k] - plain[k]).abs().mean()) / interval,
                 "max_planes": float((out[k] - plain[k]).abs().max()) / interval}
             for k in ("depth", "depth_agg_initial", "depth_views")}
    expected_paths = int8_expected_paths()
    ok = (not bad and not nonfinite and by_shape == INT8_MAIN_SHAPES
          and launches == INT8_EXPECTED_LAUNCHES and softargmin_by_shape == MAIN_SHAPES
          and by_path == expected_paths and by_path["generic"] == 0
          and conv3d_launches == conv3d_int8mxu_launches(cfg.view_num)
          and deconv3d_launches == deconv3d_forward_launches(cfg.view_num))
    emit(phase="forward", act_quant="int8mxu", int8_launches=launches,
         conv3d_launches=conv3d_launches,
         conv3d_expected_launches=conv3d_int8mxu_launches(cfg.view_num),
         deconv3d_launches=deconv3d_launches,
         deconv3d_expected_launches=deconv3d_forward_launches(cfg.view_num),
         expected_int8_launches=INT8_EXPECTED_LAUNCHES,
         int8_launches_by_shape={"x".join(map(str, k)): v for k, v in by_shape.items()},
         int8_launches_by_path=by_path, expected_int8_launches_by_path=expected_paths,
         softargmin_launches_by_shape=shape_counts(softargmin_by_shape), bad_shapes=bad,
         nonfinite=nonfinite, seconds_first=seconds, peak_memory_bytes=peak,
         moved_from_unquantized=moved, ok=ok)
    if bad or nonfinite:
        raise AssertionError(f"int8mxu forward outputs wrong: shapes {bad}, non-finite {nonfinite}")
    if by_shape != INT8_MAIN_SHAPES or launches != INT8_EXPECTED_LAUNCHES:
        raise AssertionError(f"int8 conv launches {by_shape}, expected {INT8_MAIN_SHAPES}")
    if by_path != expected_paths or by_path["generic"]:
        raise AssertionError(f"int8 conv launches by path {by_path}, expected {expected_paths}")
    if softargmin_by_shape != MAIN_SHAPES:
        raise AssertionError(f"soft-argmin launches under int8mxu {softargmin_by_shape}")
    if conv3d_launches != conv3d_int8mxu_launches(cfg.view_num):
        raise AssertionError(f"fp32 conv3d launches under int8mxu {conv3d_launches}, expected "
                             f"{conv3d_int8mxu_launches(cfg.view_num)}")
    if deconv3d_launches != deconv3d_forward_launches(cfg.view_num):
        raise AssertionError(f"fp32 transposed conv3d launches under int8mxu "
                             f"{deconv3d_launches}, expected "
                             f"{deconv3d_forward_launches(cfg.view_num)}")
    return launches, by_path


def phase_int8_only(kind, baseline=None):
    """`--only int8`: the kernel checks, the flagship int8mxu forward and its profile, the
    timings; with a baseline checkout, its int8 kernel in turns with this one."""
    phase_kernel_int8()
    cfg = PipelineConfig()
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    phase_forward_int8(model, images, cams, cfg)
    phase_profile(model, images, cams, cfg.replace(act_quant="int8mxu"))
    del model
    torch.cuda.empty_cache()
    phase_timing_int8(kind)
    if baseline:
        phase_int8_turns(load_baseline(baseline, "int8_conv"), baseline)


def load_baseline(root: str, module: str = "softargmin"):
    """atvsnet_torch/ops/<module>.py of another checkout (say the parent commit unpacked
    under build/), loaded beside this one under its own name. Its sources and library are
    that checkout's (the module finds them through this tree's ops.nvcc, so they are set
    here): it builds its own library into that checkout's build/ directory."""
    import importlib.util
    ops = os.path.join(root, "atvsnet_torch", "ops")
    spec = importlib.util.spec_from_file_location(f"baseline_{module}", os.path.join(ops, f"{module}.py"))
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    base.SOURCE = Path(root, "atvsnet_torch", "csrc", base.SOURCE.name).resolve()
    base.LIBRARY = Path(root, "build", "atvsnet_torch", base.LIBRARY.name).resolve()
    if hasattr(base, "LIB"):   # a checkout whose library is an ops.nvcc.CudaLibrary
        base.LIB.source, base.LIB.library = base.SOURCE, base.LIBRARY
    base.build(force=True)
    return base


def phase_int8_turns(base, root: str):
    """The int8 conv kernel of this tree against `base`'s (load_baseline of ops/int8_conv)
    on the same inputs in turns (base, this, this, base), at every INT8_MAIN_SHAPES class,
    fp32 and bf16 out; and the sum of each over one fp32 flagship forward."""
    scale = torch.tensor(INT8_SCALE, device="cuda")
    forward = {"base": 0.0, "this": 0.0}
    for key, n in INT8_MAIN_SHAPES.items():
        shape, co, stride = key[:5], key[5], key[6]
        pads = int8_pads(shape, stride)
        nbuf = max(2, math.ceil(200e6 / math.prod(shape)))
        bufs = [int8_inputs(shape, co, seed=900 + i) for i in range(nbuf)]
        for out_dtype in (torch.float32, torch.bfloat16):
            fns = {"base": lambda x, w: base.conv3d_int8_cuda(x, w, stride, pads, scale, out_dtype),
                   "this": lambda x, w: I8.conv3d_int8_cuda(x, w, stride, pads, scale, out_dtype)}
            want = base.conv3d_int8_cuda(*bufs[0], stride, pads, scale, out_dtype)
            same = bool(torch.equal(I8.conv3d_int8_cuda(*bufs[0], stride, pads, scale, out_dtype), want))
            ms = {"base": [], "this": []}
            for who in ("base", "this", "this", "base"):
                ms[who].append(device_ms(fns[who], bufs, 20))
            emit(phase="timing", what="conv3d_int8", turns="base, this, this, base", baseline=root,
                 input=list(shape), co=co, stride=stride, out_dtype=str(out_dtype).split(".")[-1],
                 path=I8.launch_plan(shape, co, stride, pads, out_dtype)["path"],
                 base_ms=ms["base"], this_ms=ms["this"], equal_to_base=same,
                 this_over_base=sum(ms["this"]) / sum(ms["base"]))
            if not same:
                raise AssertionError(f"the int8 kernel differs from the baseline's at {key}")
            if out_dtype == torch.float32:
                for who in forward:
                    forward[who] += n * sum(ms[who]) / 2
        del bufs
        torch.cuda.empty_cache()
    emit(phase="timing", what="conv3d_int8 per fp32 flagship forward", turns="base, this, this, base",
         baseline=root, base_ms=forward["base"], this_ms=forward["this"])


def phase_kernel_turns(base, root: str):
    """The kernels of this tree against those of `base` (load_baseline) on the same inputs
    in turns (base, this, this, base): the forward without statistics at the timed shapes,
    the whole-volume backward at the train and flagship shapes, the stats-fed backward at
    SPLIT_SHAPES, the partial forward at SPLIT_SHAPES and the depth phase's train slice
    (DEPTH_TRAIN_SHAPE), fp32 and bf16, and at the native slice in fp32 also right after
    another kernel (the partial forward's launch overlaps the kernel before it). A
    baseline whose softargmin_backward_cuda takes no statistics (before the one gradient
    kernel) recomputes them; it gets the same depth and gradient."""
    import inspect
    base_has_stats = "stats" in inspect.signature(base.softargmin_backward_cuda).parameters

    def base_backward(c, ds, di, stats, depth, g):
        if base_has_stats:
            return base.softargmin_backward_cuda(c, ds, di, stats, depth, g)
        return base.softargmin_backward_cuda(c, ds, di, depth, g)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("softargmin", s_, d_) for s_, d_ in [
        ((1, 128, 120, 224), f32), ((1, 128, 120, 896), f32), ((1, 128, 128, 160), f32),
        ((1, 128, 120, 224), bf16), (TRAIN_SHAPE, bf16)]]
    cases += [("softargmin_backward", s_, d_) for s_, d_ in [
        (TRAIN_SHAPE, bf16), (TRAIN_SHAPE, f32), ((1, 128, 120, 224), f32),
        ((1, 128, 120, 896), f32), ((1, 128, 120, 224), bf16)]]
    cases += [("softargmin_backward_stats", s_, d_) for s_, d_ in [
        (SPLIT_SHAPES[0], f32), (SPLIT_SHAPES[0], bf16), (SPLIT_SHAPES[1], f32)]]
    cases += [("softargmin_partial", s_, d_) for s_ in SPLIT_SHAPES + (DEPTH_TRAIN_SHAPE,)
              for d_ in (f32, bf16)]
    for what, shape, dtype in cases:
        elem = torch.tensor([], dtype=dtype).element_size()
        nbuf = max(2, math.ceil(200e6 / (math.prod(shape) * elem)))
        if what == "softargmin":
            bufs = [kernel_inputs(shape, dtype, seed=600 + i) for i in range(nbuf)]
            fns = {"base": base.softargmin_cuda, "this": S.softargmin_cuda}
        elif what == "softargmin_backward":
            bufs = [backward_inputs(shape, dtype, 600 + i) for i in range(nbuf)]
            fns = {"base": base_backward, "this": S.softargmin_backward_cuda}
        elif what == "softargmin_partial":
            bufs = [split_inputs(shape, dtype, 600 + i)[1:5] for i in range(nbuf)]
            fns = {"base": base.softargmin_partial_cuda, "this": S.softargmin_partial_cuda}
        else:
            bufs = [split_inputs(shape, dtype, 600 + i)[1:] for i in range(nbuf)]
            fns = {"base": base.softargmin_backward_stats_cuda,
                   "this": S.softargmin_backward_stats_cuda}
        ms = {"base": [], "this": []}
        for who in ("base", "this", "this", "base"):
            ms[who].append(device_ms(fns[who], bufs, 50))
        after = None
        if what == "softargmin_partial" and shape == SPLIT_SHAPES[0] and dtype == f32:
            # right after another kernel, as on the main path (a convolution there, an
            # elementwise add over 64 MB here): the pair's time less the add's alone
            x = torch.zeros(2**24, device="cuda")
            add_ms = device_ms(lambda *_: x.add_(1.0), bufs, 50)
            after = {"base": [], "this": [], "add_ms": add_ms}
            for who in ("base", "this", "this", "base"):
                pair = device_ms(lambda *b: (x.add_(1.0), fns[who](*b)), bufs, 50)
                after[who].append(pair - add_ms)
        del bufs
        emit(phase="timing", what=what, turns="base, this, this, base", baseline=root,
             shape=list(shape), dtype=str(dtype).split(".")[-1], base_ms=ms["base"],
             this_ms=ms["this"], this_over_base=sum(ms["this"]) / sum(ms["base"]),
             after_another_kernel=after)


def depth_rank_forward(mesh, model, cfg, images, cams) -> dict:
    """sharded_run with every kernel's launches of the counted forward."""
    res = sharded_run(mesh, model, cfg, images, cams)
    res.update(mesh=[mesh.n_data, mesh.n_view, mesh.n_depth], depth_rank=mesh.depth_rank,
               split=split_launch_record())
    return res


def depth_shared_card():
    """(a), (c) and (d) of the depth phase on one rank of the 2-rank gloo world on cuda:0."""
    torch.backends.cudnn.deterministic = True
    cfg = PipelineConfig()
    model = load_model(SPHERES, cfg, device="cuda:0")
    images, cams = parallel_scenes(cfg, 1)
    res = {"forward": depth_rank_forward(make_mesh(1, 1, 2, device="cuda:0"), model, cfg,
                                         images, cams)}
    del model
    torch.cuda.empty_cache()
    # (c) the train-size loss and backward on depth=2
    tcfg_size = PipelineConfig(**TRAIN_SIZE)
    mesh = make_mesh(1, 1, 2, device="cuda:0")
    model = load_model(SPHERES, tcfg_size, device="cuda:0").requires_grad_(True)
    batch = parallel_train_batch(tcfg_size)
    loss_and_grads(model, batch, tcfg_size, TrainConfig(), mesh)      # warm
    torch.cuda.synchronize()
    S.reset_launch_counts()
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(model, batch, tcfg_size, TrainConfig(), mesh)
    torch.cuda.synchronize()
    res["train"] = {"seconds": time.perf_counter() - t0, "loss": float(loss),
                    "launches": split_launch_record(),
                    "grads": {n: g.cpu().numpy() for n, g in grads.items()}}
    del model, grads
    torch.backends.cudnn.deterministic = False
    # (d) the flagship fp32 train step, remat on, on depth=2; two steps, the second timed
    torch.cuda.empty_cache()
    flag = cfg.replace(remat=True)
    model = load_model(SPHERES, flag, device="cuda:0")
    opt = make_optimizer(TrainConfig())
    state = init_train_state(model, opt)
    step = sharded_train_step(mesh, flag, TrainConfig(), opt)
    flag_batch = train_batch(flag, seed=21)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for _ in range(2):
        S.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, flag_batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    res["flagship_step"] = {"seconds_each": seconds, "losses": losses,
                            "peak_bytes": torch.cuda.max_memory_allocated(),
                            "launches": split_launch_record()}
    return res


def depth_shared_card4():
    """(a) on one rank of the 4-rank gloo world on cuda:0: the flagship forward on
    (1, 2, 2), each rank held to SHARED4_MEMORY_FRACTION of the card."""
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_per_process_memory_fraction(SHARED4_MEMORY_FRACTION, 0)
    cfg = PipelineConfig()
    model = load_model(SPHERES, cfg, device="cuda:0")
    images, cams = parallel_scenes(cfg, 1)
    return depth_rank_forward(make_mesh(1, 2, 2, device="cuda:0"), model, cfg, images, cams)


def depth_nccl(size: int):
    """(b) on one rank of the NCCL world: D split over as many cards as it divides."""
    torch.backends.cudnn.deterministic = True
    cfg = PipelineConfig()
    n_depth = max(d for d in range(1, size + 1) if size % d == 0 and cfg.max_d % (8 * d) == 0)
    mesh = make_mesh(size // n_depth, 1, n_depth)
    model = load_model(SPHERES, cfg, device=mesh.device)
    images, cams = parallel_scenes(cfg, mesh.n_data)
    return dict(depth_rank_forward(mesh, model, cfg, images, cams), backend=dist.get_backend(),
                device=str(mesh.device))


def phase_depth() -> dict:
    """The 'depth' mesh axis: (a) the flagship forward on depth=2 (2 ranks sharing cuda:0
    over gloo) and on (1, 2, 2) (4 ranks); (b) an NCCL world of device_count() ranks with
    'depth' as large as it divides; (c) the train-size fp32 loss and backward on depth=2
    against one process; (d) the flagship fp32 train step with remat on depth=2. Returns
    the depth-split kernels' launches over every rank's counted runs."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        shared = run_ranks(2, {"backend": "gloo", "store": os.path.join(tmp, "store")},
                           depth_shared_card)
    shared4, why_not4 = None, None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            shared4 = run_ranks(4, {"backend": "gloo", "store": os.path.join(tmp, "store")},
                                depth_shared_card4)
    except AssertionError as e:
        if "out of memory" not in str(e).lower():
            raise
        why_not4 = ("four ranks did not fit one card at "
                    f"{SHARED4_MEMORY_FRACTION} of its memory each: " + str(e)[-600:])
    count = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    nccl = run_ranks(count, {"backend": "nccl", "port": port}, depth_nccl, count)

    # the references, in this process once the worlds are done
    torch.backends.cudnn.deterministic = True
    cfg = PipelineConfig()
    model = load_model(SPHERES, cfg, device="cuda")
    n_rows = max(1, nccl[0]["mesh"][0])
    images, cams = parallel_scenes(cfg, n_rows)
    single = [multi_view_forward(model, images[i:i + 1], cams[i:i + 1], cfg) for i in range(n_rows)]
    single = {k: torch.cat([o[k].cpu() for o in single], dim=1 if k == "depth_views" else 0)
              for k in DEPTH_KEYS}
    del model
    tcfg_size = PipelineConfig(**TRAIN_SIZE)
    model = load_model(SPHERES, tcfg_size, device="cuda").requires_grad_(True)
    loss_1, _, grads_1 = loss_and_grads(model, parallel_train_batch(tcfg_size), tcfg_size,
                                        TrainConfig())
    grads_1 = {n: g.cpu() for n, g in grads_1.items()}
    del model
    torch.backends.cudnn.deterministic = False

    def forward_record(ranks):
        n_data, n_view, n_depth = ranks[0]["mesh"]
        want = {k: v[:, :n_data] if k == "depth_views" else v[:n_data] for k, v in single.items()}
        agree = depth_differences(ranks[0]["depths"], want, DEPTH_KEYS)
        same = all(np.array_equal(r["depths"][k], ranks[0]["depths"][k])
                   for r in ranks for k in DEPTH_KEYS)
        pairs = (cfg.view_num - 1) // n_view
        if n_depth > 1:
            expected = depth_shapes(pairs, n_depth)
            launches_ok = all(r["split"]["partial"]["by_shape"] == shape_counts(expected)
                              and r["split"]["partial"]["by_path"]["scalar"] == 0
                              and r["split"]["forward"]["launches"] == 0 for r in ranks)
        else:
            expected = parallel_shapes(pairs)
            launches_ok = all(r["by_shape"] == expected and r["split"]["partial"]["launches"] == 0
                              for r in ranks)
        return {"mesh": ranks[0]["mesh"], "vs_one_process": agree,
                "ranks_agree_to_the_bit": same,
                "per_rank": [{"seconds": r["seconds"], "peak_bytes": r["peak_bytes"],
                              "launches": r["split"]} for r in ranks],
                "expected_by_shape": shape_counts(expected),
                "ok": within_batch_bounds(agree) and same and launches_ok}

    a = {"depth=2": forward_record([r["forward"] for r in shared])}
    if shared4 is not None:
        a["view=2 depth=2"] = forward_record(shared4)
    ok_a = all(v["ok"] for v in a.values())
    emit(phase="depth", part="a: the flagship forward, ranks sharing cuda:0 over gloo", runs=a,
         four_ranks_skipped_because=why_not4, memory_fraction_of_four=SHARED4_MEMORY_FRACTION,
         batch_mean_diff=BATCH_MEAN_DIFF, batch_diff_at=BATCH_DIFF_AT,
         batch_max_share=BATCH_MAX_SHARE, ok=ok_a)

    b = forward_record(nccl)
    ok_b = b["ok"] and all(r["backend"] == "nccl" for r in nccl)
    emit(phase="depth", part="b: one rank per card over NCCL, depth as large as it divides",
         world_size=count, devices=[r["device"] for r in nccl], run=b, ok=ok_b)

    per = []
    want = {"x".join(map(str, DEPTH_TRAIN_SHAPE)): DEPTH_TRAIN_LAUNCHES[0]}
    for r in shared:
        res = r["train"]
        loss_rel = abs(res["loss"] - float(loss_1)) / abs(float(loss_1))
        rel = grad_rel({n: torch.from_numpy(g) for n, g in res["grads"].items()}, grads_1)
        launches = res["launches"]
        per.append({"loss": res["loss"], "loss_rel": loss_rel, "grad_rel": rel,
                    "seconds": res["seconds"], "launches": launches,
                    "ok": (loss_rel <= PARALLEL_LOSS_RTOL and rel <= PARALLEL_GRAD_REL
                           and (launches["partial"]["launches"],
                                launches["backward_stats"]["launches"]) == DEPTH_TRAIN_LAUNCHES
                           and launches["partial"]["by_shape"] == want
                           and launches["forward"]["launches"] == 0
                           and launches["backward"]["launches"] == 0)})
    ok_c = all(p["ok"] for p in per)
    emit(phase="depth", part="c: train-size loss and backward on depth=2", size=TRAIN_SIZE,
         dtype="float32", loss_one_process=float(loss_1), loss_rtol=PARALLEL_LOSS_RTOL,
         grad_rel_bound=PARALLEL_GRAD_REL, expected_launches=list(DEPTH_TRAIN_LAUNCHES),
         per_rank=per, ok=ok_c)

    steps = [r["flagship_step"] for r in shared]
    ok_d = all(math.isfinite(v) for s_ in steps for v in s_["losses"]) and all(
        s_["launches"]["partial"]["launches"] > 0 and s_["launches"]["backward_stats"]["launches"] > 0
        for s_ in steps)
    emit(phase="depth", part="d: flagship fp32 train step, remat on, depth=2 sharing cuda:0",
         per_rank=steps, one_process_remat_on=ONE_PROCESS_REMAT_STEP,
         remat_off_per_rank=("not run: two ranks of the remat-off step need more than one "
                             "80 GB card (71.3 GB on one process); it waits for a multi-card "
                             "call" if count < 2 else "not run in this script"), ok=ok_d)
    if not (ok_a and ok_b and ok_c and ok_d):
        raise AssertionError("depth: a depth-split run disagrees or launched wrong; see above")
    runs = ([r["forward"]["split"] for r in shared] + [r["split"] for r in nccl]
            + ([r["split"] for r in shared4] if shared4 else [])
            + [r["train"]["launches"] for r in shared] + [s_["launches"] for s_ in steps])
    return {d: sum(run[d]["launches"] for run in runs) for d in ("partial", "backward_stats")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--only", nargs="+",
                    choices=["kernels", "int8", "conv2d", "conv3d", "deconv3d", "sweep",
                             "native", "fusion",
                             "eval", "train", "parallel", "quant", "depth", "precision",
                             "helpers"],
                    default=None,
                    help="after device and build, run these phases alone: a short run while "
                         "working on one of them; it prints no kernels line and no ok line")
    ap.add_argument("--baseline", default=None,
                    help="with --only kernels or int8: the root of another checkout whose "
                         "kernels (the soft-argmin's, or the int8 conv's) are timed in turns "
                         "with this tree's on the same inputs")
    args = ap.parse_args()
    if args.baseline and not (args.only and {"kernels", "int8"} & set(args.only)):
        ap.error("--baseline goes with --only kernels or --only int8")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    kind = card_kind(name)
    emit(phase="device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, bandwidth_assumed=HBM_BYTES_PER_S[kind])

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:   # one nvcc per source, together
        for built in [pool.submit(m.build, True) for m in (S, I8, C2, C3, CT, PS)]:
            built.result()
    emit(phase="build", seconds=time.perf_counter() - t0, library=os.path.relpath(S.LIBRARY, ROOT),
         ptxas=[ln for ln in S.build_log.splitlines() if "ptxas" in ln],
         int8_library=os.path.relpath(I8.LIBRARY, ROOT),
         int8_ptxas=[ln for ln in I8.build_log.splitlines() if "ptxas" in ln],
         conv2d_library=os.path.relpath(C2.LIBRARY, ROOT),
         conv2d_ptxas=[ln for ln in C2.build_log.splitlines() if "ptxas" in ln],
         conv3d_library=os.path.relpath(C3.LIBRARY, ROOT),
         conv3d_ptxas=[ln for ln in C3.build_log.splitlines() if "ptxas" in ln],
         deconv3d_library=os.path.relpath(CT.LIBRARY, ROOT),
         deconv3d_ptxas=[ln for ln in CT.build_log.splitlines() if "ptxas" in ln],
         sweep_library=os.path.relpath(PS.LIBRARY, ROOT),
         sweep_ptxas=[ln for ln in PS.build_log.splitlines() if "ptxas" in ln])

    def kernels():
        phase_kernel(), phase_kernel_backward(), phase_kernel_split(), phase_kernel_int8()
        phase_timing_kernel(kind), phase_timing_backward(kind), phase_timing_split(kind)
        phase_timing_int8(kind)
        phase_conv2d(kind)
        phase_conv3d(kind)
        phase_deconv3d(kind)
        phase_sweep(kind)
        if args.baseline:
            phase_kernel_turns(load_baseline(args.baseline), args.baseline)

    if args.only:
        for phase in args.only:
            {"kernels": kernels, "int8": lambda: phase_int8_only(kind, args.baseline),
             "conv2d": lambda: phase_conv2d(kind), "conv3d": lambda: phase_conv3d(kind),
             "deconv3d": lambda: phase_deconv3d(kind),
             "sweep": lambda: phase_sweep(kind),
             "native": phase_native,
             "fusion": lambda: phase_fusion(kind),
             "eval": phase_eval, "train": phase_train, "parallel": phase_parallel,
             "quant": phase_quant, "helpers": phase_helpers, "precision": phase_precision,
             "depth": lambda: (phase_kernel_split(), phase_timing_split(kind), phase_depth())
             }[phase]()
        print(smi, flush=True)
        return 1  # a partial run is no pass
    max_err = phase_kernel()
    max_err_bwd = phase_kernel_backward()
    max_err_partial, max_err_stats = phase_kernel_split()
    max_err_int8 = phase_kernel_int8()
    phase_small()

    cfg = PipelineConfig()                              # 5 views, 480x896, D=128, fp32
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    launches = phase_forward(model, images, cams, cfg)
    int8_launches, int8_by_path = phase_forward_int8(model, images, cams, cfg)
    totals, bound_by = phase_timing(model, images, cams, cfg, kind)
    bwd_totals, bwd_bound_by = phase_timing_backward(kind)
    split_totals, split_bound_by = phase_timing_split(kind)
    int8_totals, int8_bound_by = phase_timing_int8(kind)
    conv2d_totals = phase_conv2d(kind)
    conv3d_totals = phase_conv3d(kind)
    deconv3d_totals = phase_deconv3d(kind)
    sweep_totals = phase_sweep(kind)
    phase_profile(model, images, cams, cfg)
    phase_profile(model, images, cams, cfg.replace(act_quant="int8mxu"))
    phase_pair_batch(model, images, cams, cfg)
    del model
    torch.cuda.empty_cache()
    phase_serving(cfg)
    phase_example(cfg)
    phase_native()
    phase_fusion(kind)
    torch.cuda.empty_cache()
    eval_launches = phase_eval()
    torch.cuda.empty_cache()
    train_launches = phase_train()
    torch.cuda.empty_cache()
    parallel_launches = phase_parallel()
    torch.cuda.empty_cache()
    phase_quant()
    torch.cuda.empty_cache()
    depth_launches = phase_depth()
    torch.cuda.empty_cache()
    phase_precision()
    torch.cuda.empty_cache()
    phase_helpers()

    print(smi, flush=True)
    # launches: the flagship forward's, the eval path's, the train CLI run's and the parallel
    # phase's (summed over its ranks' counted runs), each counted from 0 over its own run;
    # the forward's ms, plain_ms and bound_ms are per flagship forward, the backward's per
    # train step of the CLI (its 4 launches at the train shape); the int8 conv's launches
    # and times are those of the flagship int8mxu forward (fp32)
    train_fwd, train_bwd = train_launches["forward"]["launches"], train_launches["backward"]["launches"]
    par_fwd, par_bwd = parallel_launches["forward"], parallel_launches["backward"]
    # the two backward entry points launch one kernel, softargmin_grad_kernel
    emit(kernels=[{
        "name": "softargmin", "kernel": "softargmin_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/softargmin.cu",
        "replaces": "atvsnet_tpu/ops/softargmin.py:26", "launches": launches + eval_launches + train_fwd + par_fwd,
        "launches_by_run": {"forward": launches, "eval": eval_launches, "train": train_fwd,
                            "parallel": par_fwd},
        "max_abs_err": max_err, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": bound_by, "library_ms": None,
    }, {
        "name": "softargmin_backward", "kernel": "softargmin_grad_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/softargmin.cu",
        "replaces": "atvsnet_tpu/ops/softargmin.py:141 (_fused_bwd, XLA formula)",
        "launches": train_bwd + par_bwd, "launches_by_run": {"train": train_bwd, "parallel": par_bwd},
        "max_abs_err": max_err_bwd, "ms": bwd_totals["ms"], "plain_ms": bwd_totals["plain_ms"],
        "bound_ms": bwd_totals["bound_ms"], "bound_by": bwd_bound_by, "library_ms": None,
    }, {
        "name": "softargmin_partial", "kernel": "softargmin_partial_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/softargmin.cu",
        "replaces": "atvsnet_tpu/ops/softargmin.py:26 (its reduction over a D split across "
                    "the 'depth' mesh axis, atvsnet_tpu/parallel/pipeline.py:51-71)",
        "launches": depth_launches["partial"], "max_abs_err": max_err_partial,
        **split_totals["partial"], "bound_by": split_bound_by["partial"], "library_ms": None,
    }, {
        "name": "softargmin_backward_stats", "kernel": "softargmin_grad_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/softargmin.cu",
        "replaces": "atvsnet_tpu/ops/softargmin.py:141 (_fused_bwd over a D split across the "
                    "'depth' mesh axis)",
        "launches": depth_launches["backward_stats"], "max_abs_err": max_err_stats,
        **split_totals["backward_stats"], "bound_by": split_bound_by["backward_stats"],
        "library_ms": None,
    }, {
        "name": "conv3d_int8", "kernel": "conv3d_int8_ring_kernel (conv3d_int8_kernel on the "
                                          "generic path)", "route": "cuda",
        "source": "atvsnet_torch/csrc/int8_conv.cu",
        "replaces": "atvsnet_tpu/nn/layers.py:233 (XLA's int8 convolution under "
                    "act_quant=int8mxu, lines 233-246; not a Pallas kernel)",
        "launches": int8_launches, "launches_by_path": int8_by_path,
        "max_abs_err": max_err_int8, "ms": int8_totals["ms"],
        "plain_ms": int8_totals["plain_ms"], "bound_ms": int8_totals["bound_ms"],
        "bound_by": int8_bound_by, "library_ms": int8_totals["library_ms"],
        "library_sums_equal": int8_totals["library_sums_equal"],
        "cudnn_float_ms": int8_totals["cudnn_float_ms"],
        "library": "cuDNN's conv3d with TF32 allowed on the int8 values held as float32: the "
                   "same sums below 2^24 (library_sums_equal: to the bit at every class); "
                   "cudnn_float_ms is the float conv with TF32 off, a yardstick",
    }, {
        "name": "conv2d_fp32", "kernel": "conv2d_fp32_igemm_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/conv2d_fp32.cu",
        "replaces": "none: cuDNN under the port's fp32 'highest' 2D convs (the JAX package "
                    "leaves them to XLA, atvsnet_tpu/nn/layers.py)",
        "launches_per_forward": {v: conv2d_forward_launches(v) for v in CONV2D_VIEWS},
        "per_forward": conv2d_totals,
        "library": "one cuDNN conv2d, TF32 off, default algorithms, on pre-padded operands",
    }, {
        "name": "conv3d_fp32", "kernel": "conv3d_fp32_direct_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/conv3d_fp32.cu",
        "replaces": "none: cuDNN under the port's fp32 'highest' 3D convs (the JAX package "
                    "leaves them to XLA, atvsnet_tpu/nn/layers.py)",
        "launches_per_forward": {v: conv3d_forward_launches(v) for v in CONV2D_VIEWS},
        "per_forward": conv3d_totals,
        "library": "one cuDNN conv3d, TF32 off, default algorithms, on pre-padded operands",
    }, {
        "name": "conv3d_transpose_fp32", "kernel": "conv3d_transpose_fp32_parity_kernel",
        "route": "cuda", "source": "atvsnet_torch/csrc/conv3d_transpose_fp32.cu",
        "replaces": "none: cuDNN under the port's fp32 'highest' 3D deconvs (the JAX package "
                    "leaves them to XLA, atvsnet_tpu/nn/layers.py deconv)",
        "launches_per_forward": {v: deconv3d_forward_launches(v) for v in CONV2D_VIEWS},
        "per_forward": deconv3d_totals,
        "library": "one cuDNN conv_transpose3d, TF32 off (convolveNd_dgrad and its setTensor5d "
                   "fill of the uncropped output)",
    }, {
        "name": "plane_sweep", "kernel": "plane_sweep_gather_kernel", "route": "cuda",
        "source": "atvsnet_torch/csrc/plane_sweep.cu",
        "replaces": "none: aten's index_select gathers and their elementwise chain under the "
                    "port's geometry.warp._sample (the JAX package's sampler is XLA's, "
                    "atvsnet_tpu/geometry/warp.py)",
        "launches_per_forward": {v: sweep_forward_launches(v) for v in CONV2D_VIEWS},
        "per_forward": sweep_totals, "library": None,
    }])
    emit(ok=True, device={"platform": "gpu", "kind": name, "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
