#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (atvsnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device     nvidia-smi name and power limit, torch and CUDA versions
  2. build      nvcc builds atvsnet_torch/csrc/softargmin.cu into build/atvsnet_torch/
  3. kernel     the CUDA soft-argmin against its plain PyTorch version (rtol 1e-5, atol
                1e-6, NaN at the same pixels) at the main path's shapes, at edge shapes
                (odd h*w, D = 1, 12, 130, B = 3, a pointer that is not 16-byte aligned)
                and on volumes with planes of +inf cost; each line names the kernel's
                path, "aligned" (16-byte loads) or "scalar", and the path's counter is
                checked
  4. small      a 3-view 64x96 D32 forward on trained weights, on the GPU (kernel) and on
                the CPU (plain path): the two must agree and recover the rendered scene
  5. forward    multi_view_forward at 5 views, 480x896, D=128, fp32, with the trained
                spheres weights on synthetic_scene(seed=0): shapes, finiteness, exactly
                14 kernel launches, all on the aligned path, and agreement with
                softargmin_impl="torch"
                (both with cuDNN's deterministic algorithms)
  6. timing     steady-state forward time and peak memory (default and deterministic
                cuDNN algorithms), and per-shape kernel times beside the plain
                version's, the HBM bound and an empty launch of the same grid
  7. profile    device time of one forward by kind of kernel, and its top kernels
                (torch.profiler); the idle share is read against a CUDA-event bracket
Then the kernels line, the nvidia-smi line, and last {"ok": true, "device": {...}}.

It needs CUDA: without it, it exits non-zero before printing any result. It imports
nothing of JAX or of atvsnet_tpu.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import render_multiplane_scene, synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.ops import softargmin as S
from atvsnet_torch.params import load_model

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
# GPU (kernel, cuDNN) vs CPU (plain, oneDNN) at the small size with trained weights:
# measured 4.8e-7 sweep units; bound 1e-4
SMALL_MAX_DIFF = 1e-4


def emit(**record):
    print(json.dumps(record), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_kind(name: str) -> str:
    return "pcie" if "pcie" in name.lower() else "sxm"


def bound_ms(shape, elem_bytes: int, kind: str):
    """Least time for one soft-argmin call: bytes (cost read once, depth written once,
    start/interval read once) over HBM bandwidth vs operations over the fp32 peak."""
    B, D, h, w = shape
    nbytes = B * D * h * w * elem_bytes + B * h * w * 4 + 2 * B * 4
    t_bytes = nbytes / HBM_BYTES_PER_S[kind] * 1e3
    t_ops = B * D * h * w * FLOPS_PER_ELEMENT / FP32_FLOP_PER_S[kind] * 1e3
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
        ref = S.softargmin_torch(cost, ds, di)
        torch.cuda.synchronize()
        took = [p for p in S.PATHS if S.softargmin_cuda.path_launches[p] == before[p] + 1]
        nan_ref, nan_got = torch.isnan(ref), torch.isnan(got)
        err = torch.where(nan_ref, torch.zeros_like(ref), (got - ref).abs())
        ok = (took == [path] and torch.equal(nan_ref, nan_got)
              and bool((err <= ATOL + RTOL * ref.abs())[~nan_ref].all()))
        # only the all-planes case has NaN, at pixel (0, 0) of every sample, on both sides
        ok = ok and int(nan_ref.sum()) == (shape[0] if transform == "all" else 0)
        if transform == "peaked":
            ok = ok and bool(((got - 2.5).abs() <= 1e-4).all())
        emit(phase="kernel", case=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
             path=took, nan_pixels=int(nan_got.sum()), max_abs_err=float(err.max()),
             max_rel_err=float((err / ref.abs())[~nan_ref].max()), ok=ok)
        if not ok:
            raise AssertionError(f"soft-argmin kernel case '{name}' at {shape}: wrong path, NaN "
                                 "pattern or values against the plain version")
        worst = max(worst, float(err.max()))
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
    S.softargmin_cuda.launches = 0
    S.softargmin_cuda.path_launches = dict.fromkeys(S.PATHS, 0)
    out = multi_view_forward(model, images, cams, cfg)
    torch.cuda.synchronize()
    launches = S.softargmin_cuda.launches
    by_path = dict(S.softargmin_cuda.path_launches)
    B, N, H, W = 1, cfg.view_num, cfg.max_h, cfg.max_w
    h, w, D, P = H // 4, W // 4, cfg.max_d, N - 1
    shapes = {"depth": (B, h, w, 1), "depth_up": (B, H, W, 1), "depth_agg_initial": (B, h, w, 1),
              "prob_volume_agg": (B, D, h, w), "prob_volumes": (P, B, D, h, w),
              "refined_prob_volumes": (P, B, D, h, w), "depth_views": (P, B, h, w, 1)}
    bad = [k for k, s in shapes.items() if tuple(out[k].shape) != s]
    nonfinite = [k for k in shapes if not bool(torch.isfinite(out[k]).all())]

    S.softargmin_cuda.launches = 0
    plain = multi_view_forward(model, images, cams, cfg.replace(softargmin_impl="torch"))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    if S.softargmin_cuda.launches != 0:
        raise AssertionError("softargmin_impl='torch' launched the kernel")
    agree = {}
    for k in ("depth", "depth_up", "depth_agg_initial", "depth_views"):
        d = (out[k] - plain[k]).abs()
        agree[k] = {"max_abs": float(d.max()), "share_over": float((d > DIFF_AT).float().mean())}
    agree_ok = all(v["max_abs"] <= MAX_DIFF and v["share_over"] <= MAX_DIFF_SHARE
                   for v in agree.values())
    depth = out["depth"]
    emit(phase="forward", launches=launches, expected_launches=EXPECTED_LAUNCHES,
         launches_by_path=by_path, bad_shapes=bad, nonfinite=nonfinite, depth_mean=float(depth.mean()),
         depth_min=float(depth.min()), depth_max=float(depth.max()),
         kernel_vs_plain=agree, diff_at=DIFF_AT, max_share=MAX_DIFF_SHARE, max_diff=MAX_DIFF,
         ok=(not bad and not nonfinite and launches == EXPECTED_LAUNCHES
             and by_path["aligned"] == launches and agree_ok))
    if bad or nonfinite:
        raise AssertionError(f"forward outputs wrong: shapes {bad}, non-finite {nonfinite}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} soft-argmin kernel launches, expected {EXPECTED_LAUNCHES}")
    if by_path["aligned"] != launches:
        raise AssertionError(f"the main path left the kernel's aligned path: {by_path}")
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

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = "bytes"
    f32, bf16 = torch.float32, torch.bfloat16
    # the main path's two calls, then what it does not run: bf16, and the scalar path at
    # the native shape (through a pointer that is not 16-byte aligned)
    for shape, dtype, path in [((1, 128, 120, 224), f32, "aligned"), ((1, 128, 120, 896), f32, "aligned"),
                               ((1, 128, 120, 224), bf16, "aligned"),
                               ((1, 128, 120, 224), f32, "scalar"), ((1, 128, 120, 224), bf16, "scalar")]:
        elem = torch.tensor([], dtype=dtype).element_size()
        nbuf = max(2, math.ceil(200e6 / (math.prod(shape) * elem)))
        bufs = [kernel_inputs(shape, dtype, seed=100 + i) for i in range(nbuf)]
        if path == "scalar":
            bufs = [(misaligned_view(c), ds, di) for c, ds, di in bufs]
        if {S.kernel_path(c.data_ptr(), shape[2] * shape[3], dtype) for c, _, _ in bufs} != {path}:
            raise AssertionError(f"timing buffers at {shape} are not all on the {path} path")
        k_ms = device_ms(S.softargmin_cuda, bufs, 50)
        p_ms = device_ms(S.softargmin_torch, bufs, 20)
        e_ms = device_ms(lambda c, ds, di: S.empty_launch(c), bufs, 50)
        b_ms, b_by = bound_ms(shape, elem, kind)
        emit(phase="timing", what="softargmin", shape=list(shape), dtype=str(dtype).split(".")[-1],
             path=path, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
             empty_launch_ms=e_ms, kernel_over_bound=k_ms / b_ms,
             kernel_gb_per_s=(math.prod(shape) * elem) / (k_ms * 1e-3) / 1e9,
             library_ms=None, library="none: no single PyTorch call computes soft-argmin")
        del bufs
        if dtype == f32 and path == "aligned":
            n = MAIN_SHAPES[shape]
            totals["ms"] += n * k_ms
            totals["plain_ms"] += n * p_ms
            totals["bound_ms"] += n * b_ms
            bound_by = b_by if b_by == "operations" else bound_by
    return totals, bound_by


def phase_profile(model, images, cams, cfg):
    """Device time of one forward by kind of work, from torch.profiler's kernel events."""
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
    categories = {"cuDNN conv + cuBLAS gemm (incl. FFT conv)": ("conv", "xmma", "gemm", "fft",
                                                             "Tensor5d", "nchw", "nhwc", "DSE::",
                                                             "region_transform"),
                  "softargmin (this repo's CUDA kernel)": ("softargmin",),
                  "gather (warp sampling)": ("gather", "index"),
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
    emit(phase="profile", wall_ms=wall * 1e3, event_ms=event_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / event_ms, device_ms_by_kind=split,
         top_kernels=[{"name": e.key[:90], "device_ms": getattr(e, attr) / 1e3, "calls": e.count}
                      for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    kind = card_kind(name)
    emit(phase="device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, bandwidth_assumed=HBM_BYTES_PER_S[kind])

    t0 = time.perf_counter()
    S.build(force=True)
    emit(phase="build", seconds=time.perf_counter() - t0, library=os.path.relpath(S.LIBRARY, ROOT),
         ptxas=[ln for ln in S.build_log.splitlines() if "ptxas" in ln])

    max_err = phase_kernel()
    phase_small()

    cfg = PipelineConfig()                              # 5 views, 480x896, D=128, fp32
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    launches = phase_forward(model, images, cams, cfg)
    totals, bound_by = phase_timing(model, images, cams, cfg, kind)
    phase_profile(model, images, cams, cfg)

    print(smi, flush=True)
    emit(kernels=[{
        "name": "softargmin", "route": "cuda", "source": "atvsnet_torch/csrc/softargmin.cu",
        "replaces": "atvsnet_tpu/ops/softargmin.py:26", "launches": launches,
        "max_abs_err": max_err, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": bound_by, "library_ms": None,
    }])
    emit(ok=True, device={"platform": "gpu", "kind": name, "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
