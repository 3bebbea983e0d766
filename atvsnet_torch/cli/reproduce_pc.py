"""End-to-end point-cloud reproduction (the port of atvsnet_tpu/cli/reproduce_pc.py) —
equivalent of reference atvsnet/reproduce_pc.sh: depth inference over the 5 ETH3D low-res
scenes, then per-scene fusion to PLY.

    python -m atvsnet_torch.cli.reproduce_pc --data_root ../data --savepath ./eval_out \
        [--scenes lakeside ...] [--params model.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from atvsnet_torch.cli.eval_pointcloud import ETH3D_SCENES, run_eval_pc
from atvsnet_torch.fusion.fuse import fuse_scene
from atvsnet_torch.utils import log


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", default="../data/")
    ap.add_argument("--savepath", default="./eval_out/")
    ap.add_argument("--scenes", nargs="*", default=ETH3D_SCENES)
    ap.add_argument("--view_num", type=int, default=8)
    ap.add_argument("--max_d", type=int, default=128)
    ap.add_argument("--max_w", type=int, default=896)
    ap.add_argument("--max_h", type=int, default=480)
    ap.add_argument("--params", default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--prob_threshold", type=float, default=0.8)
    ap.add_argument("--disp_threshold", type=float, default=0.01)
    ap.add_argument("--num_consistent", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (an error without CUDA)")
    args = ap.parse_args()

    run_eval_pc(
        args.data_root, args.savepath, args.scenes,
        view_num=args.view_num, max_d=args.max_d, max_w=args.max_w, max_h=args.max_h,
        params_path=args.params, compute_dtype=args.dtype, device=args.device,
    )
    for scene in args.scenes:
        dense = os.path.join(args.savepath, scene)
        if not os.path.isdir(os.path.join(dense, "depths_atvsnet")):
            log.warn(f"no depths for scene {scene}, skipping fusion")
            continue
        fuse_scene(
            dense,
            prob_threshold=args.prob_threshold,
            disp_threshold=args.disp_threshold,
            num_consistent=args.num_consistent,
            device=args.device,
        )


if __name__ == "__main__":
    main()
