"""Example inference CLI (the port of atvsnet_tpu/cli/example.py; reference
atvsnet/example.py).

    python -m atvsnet_torch.cli.example --root_path example --example_index 0 \
        --view_num 5 [--params model.npz] [--device cpu]

Loads example/{i}/{v}.jpg + {v}_cam.npy (raw images, 1/4-scale intrinsics,
inverse-depth sweep row; reference example.py:326-342), runs the two-view or N-view
forward on the GPU (or on --device), and writes pred.npy, pred.jpg and
error.json/xlsx against 0_gt.npy.

Without --params it runs with seeded random weights; the outputs are then structurally
valid only.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from atvsnet_torch import resolve_device
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data import image_io
from atvsnet_torch.data.preprocess import load_example_dir
from atvsnet_torch.eval.errors import calc_error, error_dict, save_error_report
from atvsnet_torch.models.atvsnet import multi_view_forward, sweep_to_depth
from atvsnet_torch.models.tvsnet import two_view_forward
from atvsnet_torch.params import init_model, load_model
from atvsnet_torch.utils import log


def save_colormap(path: str, img: np.ndarray) -> None:
    """Viridis visualization of a 2D map, scaled to its own range."""
    image_io.imwrite(path, image_io.colormap(img))


def run_example(
    root_path: str,
    example_index: int,
    view_num: int,
    params_path: str | None = None,
    savepath: str | None = None,
    max_d: int = 128,
    seed: int = 0,
    device=None,
) -> dict:
    device = resolve_device(device)
    data_root = os.path.join(root_path, str(example_index))
    # honor available views (reference example.py:312-324)
    valid = 0
    for v in range(view_num):
        if os.path.exists(os.path.join(data_root, f"{v}.jpg")) and os.path.exists(
            os.path.join(data_root, f"{v}_cam.npy")
        ):
            valid += 1
    if valid != view_num:
        log.warn(f"only {valid} views found (view_num={view_num}), continuing with {valid}")
        view_num = valid

    # the frames stay raw (un-normalized BGR float32), as the reference feeds them
    images, cams, depth_gt = load_example_dir(data_root, view_num)
    cfg = PipelineConfig(view_num=view_num, max_d=max_d)

    if params_path:
        if not os.path.exists(params_path):
            raise SystemExit(f"error: --params checkpoint not found: {params_path}")
        model = load_model(params_path, cfg, device)
        log.info(f"params restored from {params_path}")
    else:
        log.warn("no --params given: using seeded random weights")
        model = init_model(cfg, seed, device)

    forward = two_view_forward if view_num == 2 else multi_view_forward

    def timed_call():
        t0 = time.perf_counter()
        depth_up = forward(model, images, cams, cfg)["depth_up"]
        depth = sweep_to_depth(depth_up, cfg.inverse_depth)
        out = depth_up.cpu().numpy(), depth.cpu().numpy()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    _, first_call = timed_call()
    (depth_sweep, depth), second_call = timed_call()
    log.info(f"first call {first_call:.2f}s, second call {second_call:.3f}s")

    disp = depth_sweep.squeeze()
    depth = depth.squeeze()
    # reference example.py:184-186 maps non-positive inverse depth to +inf then 1/x;
    # sweep_to_depth returns 0 there, matching the valid-pixel convention downstream.

    savepath = savepath or os.path.join("results", f"example_{example_index}")
    os.makedirs(savepath, exist_ok=True)
    np.save(os.path.join(savepath, "pred.npy"), depth)
    save_colormap(os.path.join(savepath, "pred.jpg"), disp)

    result = {"savepath": savepath, "runtime_s": second_call, "first_call_s": first_call}
    if depth_gt is not None:
        errors, _ = calc_error(np.squeeze(depth), np.squeeze(depth_gt))
        save_error_report(os.path.join(savepath, "error.xlsx"), errors)
        result["errors"] = error_dict(errors)
        log.info("errors:", json.dumps(result["errors"], indent=2))
    log.info(f"results saved to {savepath}")
    return result


def run_examples(
    root_path: str,
    example_indices,
    view_num: int,
    params_path: str | None = None,
    savepath: str | None = None,
    max_d: int = 128,
    device=None,
) -> dict:
    """Batch mode: run several example directories and write a combined summary
    (the reference example script loops index lists into one error workbook)."""
    summary = {}
    for idx in example_indices:
        sub = os.path.join(savepath, str(idx)) if savepath else None
        summary[str(idx)] = run_example(
            root_path, idx, view_num,
            params_path=params_path, savepath=sub, max_d=max_d, device=device,
        )
    out_root = savepath or "results"
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "examples_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log.info(f"batch summary -> {os.path.join(out_root, 'examples_summary.json')}")
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root_path", default="example",
                    help="directory holding the example/{i} folders")
    ap.add_argument(
        "--example_index", default="2",
        help="example directory index, or a comma-separated list for batch mode",
    )
    ap.add_argument("--view_num", type=int, default=5)
    ap.add_argument("--params", default=None, help="npz checkpoint path")
    ap.add_argument("--savepath", default=None)
    ap.add_argument("--max_d", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (an error without CUDA)")
    args = ap.parse_args()
    if args.view_num < 2:
        ap.error("--view_num must be at least 2")
    indices = [int(s) for s in str(args.example_index).split(",")]
    if len(indices) == 1:
        run_example(
            args.root_path, indices[0], args.view_num, params_path=args.params,
            savepath=args.savepath, max_d=args.max_d, device=args.device,
        )
    else:
        run_examples(
            args.root_path, indices, args.view_num, params_path=args.params,
            savepath=args.savepath, max_d=args.max_d, device=args.device,
        )


if __name__ == "__main__":
    main()
