"""The comparisons that decide `correct`: how far the program's answers lie from the
reference's, in numbers that each have a limit in the traffic file.

Depths are compared in the units of the sweep: the program returns metric depth, the
reference the inverse depth of the soft-argmin, and a gap of 1 is one plane of the
sweep. A map's gap is its mean over the valid pixels; the numbers are the worst map's
mean gap and the largest gap of any pixel of any map. Confidences (the summed probability
of 4 planes) are compared as they are, by the worst map's mean gap only: where the
refinement's discrete decisions (nearest rounding, the visual hull's comparisons) flip on
float noise, a pixel's confidence moves by up to half its range in a sound run, so the
largest gap (`conf_max`, printed as a reading) does not tell a sound run from the control.
"""

from __future__ import annotations

import numpy as np


def sweep_of(metric_depth: np.ndarray) -> np.ndarray:
    """Metric depth back to the inverse-depth sweep (0 stays 0)."""
    d = np.asarray(metric_depth, np.float64)
    return np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)


class Gaps:
    """The worst mean and the largest gap over the maps added."""

    def __init__(self):
        self.worst_mean = 0.0
        self.largest = 0.0
        self.maps = 0

    def add(self, got: np.ndarray, want: np.ndarray, scale: float = 1.0):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape:
            raise ValueError(f"answer of shape {got.shape}, reference {want.shape}")
        gap = np.abs(got - want) / scale
        gap = np.where(np.isfinite(gap), gap, np.inf)
        self.worst_mean = max(self.worst_mean, float(gap.mean()))
        self.largest = max(self.largest, float(gap.max()))
        self.maps += 1

    def add_depth(self, metric_depth, ref_sweep, interval: float):
        self.add(sweep_of(metric_depth), ref_sweep, interval)

    def checks(self, limits: dict, what: str = "depth") -> dict:
        """The numbers compared: a depth's worst mean and largest gap in planes; a
        confidence's worst mean alone (see `conf_max` in the module's notes)."""
        if what == "depth":
            return {"depth_mean_planes": (self.worst_mean, limits["depth_mean_planes"]),
                    "depth_max_planes": (self.largest, limits["depth_max_planes"])}
        return {f"{what}_mean": (self.worst_mean, limits[f"{what}_mean"])}


def cloud_unmatched(got: np.ndarray, want: np.ndarray, tol: float = 1e-5) -> float:
    """Share of points that only one cloud has: points of either cloud with no point of
    the other within `tol` (metres), over the reference's count. Neighbouring pixels lie
    millimetres apart at these depths, so a match within 10 um is the same pixel's point."""
    from scipy.spatial import cKDTree

    if len(want) == 0:
        return 0.0 if len(got) == 0 else float("inf")
    if len(got) == 0:
        return 1.0
    d_got, _ = cKDTree(want).query(got, distance_upper_bound=tol)
    d_want, _ = cKDTree(got).query(want, distance_upper_bound=tol)
    return float((np.isinf(d_got).sum() + np.isinf(d_want).sum()) / len(want))
