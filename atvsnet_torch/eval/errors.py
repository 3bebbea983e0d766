"""Depth map error metrics — 10 error + 4 inlier-ratio metrics.

Exact port of the verification oracle at reference atvsnet/eval_errors.py:25-93
(numpy, host side; the port's copy of atvsnet_tpu/eval/errors.py, held against it by
tests/test_torch_data.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

INLIER_THRESHOLDS = [1, 3, 5, 10]

ERR_METRICS = [
    "mae",
    "rmse",
    "inverse_mae",
    "inverse_rmse",
    "log_mae",
    "log_rmse",
    "scale_invariant_log",
    "abs_relative",
    "squared_relative",
    "mae_normalized",
]

ACC_METRICS = [f"inlier_ratios_{t}" for t in INLIER_THRESHOLDS]


def calc_error(
    depth_predict_in: np.ndarray,
    depth_gt_in: np.ndarray,
    num_depths: int = 100,
    inlier_threshold: List[int] = INLIER_THRESHOLDS,
) -> Tuple[np.ndarray, list]:
    assert depth_predict_in.shape == depth_gt_in.shape

    depth_predict = depth_predict_in.copy().astype(np.float64)
    depth_gt = depth_gt_in.copy().astype(np.float64)
    depth_gt[np.isnan(depth_gt)] = 0.0
    depth_predict[np.isnan(depth_predict)] = 0.0

    depthvec = depth_gt.flatten()
    depthvec = depthvec[(depthvec < 1e10) * (depthvec > 0.0)]
    depthvec = np.sort(depthvec)
    depth_interval = float(depthvec[-1] - depthvec[0]) / float(num_depths)

    valid_mask = (depth_gt > 0.0) * (depth_gt < 1e10) * (depth_predict > 0.0) * (depth_predict < 1e10)
    valid_num = float(np.sum(valid_mask))
    assert valid_num > 0

    depth_gt[~valid_mask] = 1.0
    depth_predict[~valid_mask] = 1.0

    errors = np.zeros(10 + len(inlier_threshold), dtype=np.float32)

    d_err = valid_mask * np.abs(depth_gt - depth_predict)
    d_err_squared = d_err * d_err
    d_err_inv = valid_mask * np.abs(1.0 / depth_gt - 1.0 / depth_predict)
    d_err_log = valid_mask * np.abs(np.log(depth_gt) - np.log(depth_predict))

    errors[0] = np.sum(d_err) / valid_num
    errors[1] = np.sqrt(np.sum(d_err_squared) / valid_num)
    errors[2] = np.sum(d_err_inv) / valid_num
    errors[3] = np.sqrt(np.sum(d_err_inv * d_err_inv) / valid_num)
    errors[4] = np.sum(d_err_log) / valid_num
    normalized_sq_log = np.sum(d_err_log * d_err_log) / valid_num
    errors[5] = np.sqrt(normalized_sq_log)
    log_sum = np.sum(valid_mask * (np.log(depth_gt) - np.log(depth_predict)))
    errors[6] = np.sqrt(normalized_sq_log - (log_sum * log_sum / (valid_num * valid_num)))
    errors[7] = np.sum(d_err / depth_gt) / valid_num
    errors[8] = np.sum(d_err_squared / (depth_gt * depth_gt)) / valid_num
    errors[9] = np.sum(d_err) / depth_interval / valid_num

    diff_image = d_err[valid_mask] / depth_interval
    for i, th in enumerate(inlier_threshold):
        errors[10 + i] = float(np.sum(diff_image < th)) / valid_num

    infos = [num_depths, depth_interval, depthvec[0], depthvec[-1], inlier_threshold]
    return errors, infos


def error_dict(errors: np.ndarray) -> Dict[str, float]:
    names = ERR_METRICS + ACC_METRICS
    return {n: float(v) for n, v in zip(names, errors)}


def save_error_report(path: str, errors: np.ndarray, sheet_name: str = "") -> None:
    """Persist metrics: .xlsx in the reference's layout (example.py:199-213) plus a
    .json sidecar. Uses xlsxwriter when installed, else the bundled minimal writer."""
    import json
    import os

    d = error_dict(errors)
    base, _ = os.path.splitext(path)
    with open(base + ".json", "w") as f:
        json.dump(d, f, indent=2)

    try:
        import xlsxwriter

        Workbook = xlsxwriter.Workbook
    except ImportError:
        from atvsnet_torch.utils.xlsx import Workbook

    workbook = Workbook(base + ".xlsx")
    worksheet = workbook.add_worksheet(sheet_name or "Sheet1")
    n_err = len(ERR_METRICS)
    worksheet.write(0, 1, "err")
    for i, name in enumerate(ERR_METRICS):
        worksheet.write(i + 1, 0, name)
        worksheet.write(i + 1, 1, float(errors[i]))
    worksheet.write(n_err + 1, 1, "acc")
    for i, name in enumerate(ACC_METRICS):
        worksheet.write(i + n_err + 2, 0, name)
        worksheet.write(i + n_err + 2, 1, float(errors[n_err + i]))
    workbook.close()
