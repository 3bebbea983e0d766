"""Depth-map fusion CLI (the port of atvsnet_tpu/cli/depth_fusion.py) — equivalent of
reference atvsnet/depth_fusion.py, which shells out to the fusibile CUDA binary; here the
consistency check runs in PyTorch on the GPU.

    python -m atvsnet_torch.cli.depth_fusion --dense_folder ./eval_out/lakeside \
        [--prob_threshold 0.8] [--disp_threshold 0.01] [--num_consistent 2] [--device cpu]
"""

from __future__ import annotations

import argparse

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.fusion.fuse import fuse_scene

_DEFAULTS = PipelineConfig()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dense_folder", required=True)
    ap.add_argument("--prob_threshold", type=float, default=_DEFAULTS.prob_threshold)
    ap.add_argument("--disp_threshold", type=float, default=_DEFAULTS.disp_threshold)
    ap.add_argument("--num_consistent", type=int, default=_DEFAULTS.num_consistent)
    ap.add_argument("--out_ply", default=None)
    # reference depth_fusion.py:210-211 hardcodes these --depth_min/--depth_max values
    ap.add_argument("--depth_min", type=float, default=_DEFAULTS.fusion_depth_min)
    ap.add_argument("--depth_max", type=float, default=_DEFAULTS.fusion_depth_max)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (an error without CUDA)")
    args = ap.parse_args()
    fuse_scene(
        args.dense_folder,
        prob_threshold=args.prob_threshold,
        disp_threshold=args.disp_threshold,
        num_consistent=args.num_consistent,
        out_ply=args.out_ply,
        depth_min=args.depth_min,
        depth_max=args.depth_max,
        device=args.device,
    )


if __name__ == "__main__":
    main()
