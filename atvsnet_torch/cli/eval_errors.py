"""Standalone depth-map error report (the reference computes these only inside
example.py; reference metric definitions at atvsnet/eval_errors.py:25-93).

    python -m atvsnet_torch.cli.eval_errors pred.npy gt.npy [--out error.xlsx]

Host-side numpy only: it needs no GPU.

Accepts .npy or .pfm inputs; prints the 14 metrics as JSON and optionally writes the
xlsx/json report.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from atvsnet_torch.eval.errors import calc_error, error_dict, save_error_report


def _load(path: str) -> np.ndarray:
    if path.endswith(".pfm"):
        from atvsnet_torch.data.pfm import load_pfm

        return np.asarray(load_pfm(path))
    return np.load(path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pred", help="predicted depth (.npy or .pfm)")
    ap.add_argument("gt", help="ground-truth depth (.npy or .pfm)")
    ap.add_argument("--out", default=None, help="write error.xlsx/.json report here")
    args = ap.parse_args()

    pred = np.squeeze(_load(args.pred))
    gt = np.squeeze(_load(args.gt))
    errors, infos = calc_error(pred, gt)
    print(json.dumps(error_dict(errors), indent=2))
    if args.out:
        save_error_report(args.out, errors)


if __name__ == "__main__":
    main()
