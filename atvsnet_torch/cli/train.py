"""Training CLI (the port of atvsnet_tpu/cli/train.py).

    python -m atvsnet_torch.cli.train --synthetic_planes --num_spheres 2 --steps 1000 \
        --ckpt runs/train_state.npz [--resume] [--export_params runs/params.npz] [--device cpu]

Data: an MVS-Synth/DeMoN-layout dataset (--data_root, data/mvs_syn.py), ETH3D COLMAP
scenes (--dataset colmap, data/colmap_train.py), photo-consistent rendered scenes
(--synthetic_planes, data/synthetic.render_multiplane_scene), or random-texture smoke
data (--synthetic, or no --data_root). One batch is prepared ahead on a host thread
while the device trains on the current one. Supervision: masked L1 in sweep space on
the aggregated and refined depths plus the per-pair term (models/train.py).

The full train state (params, Adam moments, count, step) is written to --ckpt every
--ckpt_every steps and at the end; --resume continues from it, schedule included.
--export_params writes the params alone in the JAX package's .npz layout, which
params.load_model here and atvsnet_tpu.utils.ckpt.load_params both read.

Runs on CUDA unless --device says otherwise. The weights start from the port's seeded
init_model, whose draws differ from the JAX package's init_params: the two CLIs do not
start from the same weights for the same --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from atvsnet_torch import resolve_device
from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.models.train import init_train_state, make_optimizer, train_step
from atvsnet_torch.params import init_model, save_params
from atvsnet_torch.utils import log
from atvsnet_torch.utils.ckpt import load_train_state, save_train_state


def synthetic_batch(cfg: PipelineConfig, rng: np.random.RandomState) -> dict:
    from atvsnet_torch.data.synthetic import synthetic_scene

    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=rng.randint(1 << 30))
    h, w = cfg.max_h // 4, cfg.max_w // 4
    gt = (0.5 + 0.05 * cfg.max_d * rng.rand(1, h, w, 1)).astype(np.float32)
    return {"images": images, "cams": cams, "depth_gt": gt}


def planes_batch(cfg: PipelineConfig, rng: np.random.RandomState, num_spheres: int = 0) -> dict:
    """A photo-consistent rendered scene (data/synthetic.render_multiplane_scene): real
    multi-view supervision without a dataset; num_spheres > 0 adds curved, occluding
    geometry."""
    from atvsnet_torch.data.synthetic import render_multiplane_scene

    s = render_multiplane_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w, D=cfg.max_d,
                                seed=rng.randint(1 << 30), inverse_depth=cfg.inverse_depth,
                                num_spheres=num_spheres)
    return {"images": s["images"], "cams": s["cams"], "depth_gt": s["depth_gt"]}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", default=None, help="dataset root (layout per --dataset)")
    ap.add_argument("--dataset", default="mvs_syn", choices=["mvs_syn", "colmap"],
                    help="mvs_syn: MVS-Synth/DeMoN layout (data/mvs_syn.py); colmap: ETH3D "
                         "COLMAP-sparse layout (data/colmap_train.py, needs --gt_root)")
    ap.add_argument("--gt_root", default=None, help="ETH3D gt depth root (colmap dataset)")
    ap.add_argument("--scenes", default=None,
                    help="comma-separated scene list (colmap dataset; default: the 5 ETH3D "
                         "training scenes)")
    ap.add_argument("--multi_depth", action="store_true",
                    help="mvs_syn: also load per-view gt depths and supervise the swapped "
                         "per-pair depths directly")
    ap.add_argument("--synthetic", action="store_true", help="train on random-texture data")
    ap.add_argument("--synthetic_planes", action="store_true",
                    help="train on photo-consistent rendered multiplane scenes")
    ap.add_argument("--num_spheres", type=int, default=0,
                    help="with --synthetic_planes: textured spheres per scene")
    ap.add_argument("--export_params", default=None,
                    help="also save a params-only npz (readable by --params of the other CLIs)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--view_num", type=int, default=3)
    ap.add_argument("--max_d", type=int, default=32)
    ap.add_argument("--max_h", type=int, default=128)
    ap.add_argument("--max_w", type=int, default=160)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"],
                    help="cosine = linear warmup then cosine decay; the schedule's step is "
                         "the optimizer's count, so --resume continues it")
    ap.add_argument("--warmup_steps", type=int, default=0)
    ap.add_argument("--decay_steps", type=int, default=None,
                    help="cosine horizon; defaults to --steps")
    ap.add_argument("--lr_final_fraction", type=float, default=0.01)
    ap.add_argument("--conf_weight", type=float, default=0.0,
                    help="weight of the confidence term (TrainConfig.loss_weight_confidence)")
    ap.add_argument("--ckpt", default="runs/train_state.npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--remat", action="store_true",
                    help="recompute per-pair stages in the backward (PipelineConfig.remat): "
                         "less device memory for more work")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--ckpt_every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path on the CPU)")
    return ap


def main(argv=None) -> dict:
    """Train; returns a summary: the steps run, each logged (step, loss), the seconds of
    the first step, steps/s after it and the device's peak memory (None on the CPU)."""
    ap = _parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # oneDNN's CPU convolution backward corrupted the heap with more than one thread (torch
    # 2.13.0+cpu): on the CPU, training runs on PyTorch's own convolutions (same values)
    with (torch.backends.mkldnn.flags(enabled=False) if device.type == "cpu"
          else contextlib.nullcontext()):
        return _train(args, ap, device)


def _train(args, ap: argparse.ArgumentParser, device: torch.device) -> dict:
    cfg = PipelineConfig(view_num=args.view_num, max_d=args.max_d, max_h=args.max_h,
                         max_w=args.max_w, compute_dtype=args.dtype, remat=args.remat)
    tcfg = TrainConfig(
        learning_rate=args.lr, lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps if args.decay_steps is not None else args.steps,
        lr_final_fraction=args.lr_final_fraction, loss_weight_confidence=args.conf_weight)
    optimizer = make_optimizer(tcfg)
    state = init_train_state(init_model(cfg, seed=args.seed, device=device), optimizer)
    if args.resume and os.path.exists(args.ckpt):
        state = load_train_state(args.ckpt, state)
        log.info(f"resumed from {args.ckpt} at step {state.step}")

    rng = np.random.RandomState(args.seed)
    if args.synthetic_planes:
        log.info("training on photo-consistent rendered multiplane scenes"
                 + (f" (+{args.num_spheres} spheres)" if args.num_spheres else ""))

        def next_batch():
            return planes_batch(cfg, rng, args.num_spheres)
    elif args.data_root and not args.synthetic and args.dataset == "colmap":
        from atvsnet_torch.data.colmap_train import (eth3d_training_samples,
                                                     load_colmap_training_sample)

        if not args.gt_root:
            ap.error("--dataset colmap requires --gt_root")
        samples, sparses = eth3d_training_samples(
            args.data_root, args.gt_root, cfg.view_num,
            scenes=args.scenes.split(",") if args.scenes else None)
        log.info(f"{len(samples)} COLMAP training samples")

        def next_batch():
            s = samples[rng.randint(len(samples))]
            return load_colmap_training_sample(
                sparses[s.scene_idx], s.ref_id, s.view_ids, s.gt_depth_path, max_d=cfg.max_d,
                max_h=cfg.max_h, max_w=cfg.max_w, inverse_depth=cfg.inverse_depth,
                augment_rng=rng)
    elif args.data_root and not args.synthetic:
        from atvsnet_torch.data.mvs_syn import MvsSynDataset, load_training_sample

        ds = MvsSynDataset(args.data_root, num_neighbors=cfg.view_num - 1, seed=args.seed)
        sample_ids = list(ds.training_samples(cfg.view_num))
        log.info(f"{len(sample_ids)} training samples")

        def next_batch():
            ids, _ = sample_ids[rng.randint(len(sample_ids))]
            return load_training_sample(ds, ids, max_d=cfg.max_d,
                                        inverse_depth=cfg.inverse_depth, augment_rng=rng,
                                        multi_depth=args.multi_depth)
    else:
        log.warn("training on synthetic data (--synthetic or no --data_root)")

        def next_batch():
            return synthetic_batch(cfg, rng)

    os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    def wait():
        if on_card:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    start = state.step
    losses, first_step_s = [], None
    t0 = t_first = wait()
    # one batch ahead: rendering or file loading is host work that would otherwise stall
    # the device between steps
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pending = pool.submit(next_batch)
        for i in range(start, args.steps):
            batch = pending.result()
            if i + 1 < args.steps:
                pending = pool.submit(next_batch)
            state, metrics = train_step(state, batch, cfg, tcfg, optimizer)
            if i == start:
                t_first = wait()
                first_step_s = t_first - t0
            if (i + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                losses.append((i + 1, loss))
                rate = (i + 1 - start) / (time.perf_counter() - t0)
                conf = (f" conf {float(metrics['confidence']):.3f}"
                        if "confidence" in metrics else "")
                log.info(f"step {i + 1}/{args.steps} loss {loss:.4f}{conf} ({rate:.2f} it/s)")
            if (i + 1) % args.ckpt_every == 0:
                save_train_state(args.ckpt, state)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    t_end = wait()
    save_train_state(args.ckpt, state)
    log.info(f"final state saved to {args.ckpt}")
    if args.export_params:
        os.makedirs(os.path.dirname(args.export_params) or ".", exist_ok=True)
        save_params(args.export_params, state.model)
        log.info(f"params exported to {args.export_params}")
    after_first = state.step - start - 1
    return {"start_step": start, "step": state.step, "losses": losses,
            "first_step_s": first_step_s,
            "steps_per_s": after_first / (t_end - t_first) if after_first > 0 else None,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if on_card else None}


if __name__ == "__main__":
    main()
