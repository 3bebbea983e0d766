"""Soft-argmin depth regression, confidence maps and align-corners upsampling
(atvsnet_tpu/geometry/depth_regression.py).

The align-corners resize is two separable interpolation matmuls; the upsampled
soft-argmin runs in output-row tiles so the 4x-upsampled volume (3.4 GB fp32 at
480x896, D=128) is never materialized whole.

Every function takes an optional depth `split` (parallel.depth.DepthSplit): the volume
holds this rank's planes, the soft-argmin merges the ranks' partial sums (per row tile
too), and the 4-bin confidence adds the bins that fall in this rank's planes before an
all-reduce. Depths and confidences come out the same on every rank.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from atvsnet_torch.ops.fp32_passes import tf32
from atvsnet_torch.ops.softargmin import finite_or_zero, softargmin, sweep


@lru_cache(maxsize=64)
def _align_corners_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix with align_corners=True semantics."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        A[:, 0] = 1.0
        return A
    if out_size == 1:
        # tf.image.resize(align_corners=True) samples the corner (index 0)
        A[0, 0] = 1.0
        return A
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        i0 = min(int(np.floor(src)), in_size - 2)
        w = src - i0
        A[i, i0] += 1.0 - w
        A[i, i0 + 1] += w
    return A


_DEVICE_MATRICES: dict = {}


def _matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """_align_corners_matrix on `device`, uploaded once per (out, in, device) and kept: a
    resize then copies nothing from the host, which a CUDA graph could not capture."""
    key = (out_size, in_size, torch.device(device))
    m = _DEVICE_MATRICES.get(key)
    if m is None:
        m = _DEVICE_MATRICES[key] = torch.from_numpy(
            _align_corners_matrix(out_size, in_size)).to(device)
    return m


@tf32(False)
def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (B, H, W, C) -> (B, out_h, out_w, C), align_corners=True bilinear, in fp32."""
    B, H, W, C = x.shape
    if (out_h, out_w) == (H, W):
        return x
    y = torch.einsum("ph,bhwc->bpwc", _matrix(out_h, H, x.device), x.to(torch.float32))
    y = torch.einsum("qw,bpwc->bpqc", _matrix(out_w, W, x.device), y)
    return y.to(x.dtype)


def upsample_prob_vol(prob_vol: torch.Tensor, up_scale: int = 4) -> torch.Tensor:
    """(B, D, h, w) -> (B, D, h*s, w*s); depth planes ride the channel axis."""
    B, D, h, w = prob_vol.shape
    x = resize_bilinear_align_corners(prob_vol.permute(0, 2, 3, 1), h * up_scale, w * up_scale)
    return x.permute(0, 3, 1, 2)


def probability_map(probability_volume: torch.Tensor, depth_map: torch.Tensor,
                    depth_start: torch.Tensor, depth_interval: torch.Tensor,
                    split=None) -> torch.Tensor:
    """Confidence: summed probability at the 4 depth bins nearest the estimate.

    probability_volume: (B, D, h, w) softmax probabilities; depth_map: (B, h, w, 1).
    floor/floor-1/ceil/ceil+1 bins, each clipped to [0, D-1]; an integer-valued
    estimate counts its own bin twice, as the reference does (model.py:13-65).
    With a split the volume holds this rank's planes: each bin adds its probability on
    the rank that holds it, as often as it occurs, and the sum is all-reduced.
    """
    D = probability_volume.shape[1] if split is None else split.depth_num
    d_idx = (depth_map[..., 0] - depth_start[:, None, None]) / depth_interval[:, None, None]
    left0 = torch.floor(d_idx).long().clamp(0, D - 1)
    left1 = (left0 - 1).clamp(0, D - 1)
    right0 = torch.ceil(d_idx).long().clamp(0, D - 1)
    right1 = (right0 + 1).clamp(0, D - 1)

    def at(idx):
        if split is None:
            return torch.gather(probability_volume, 1, idx[:, None])[:, 0]
        local = idx - split.offset
        mine = (local >= 0) & (local < split.local)
        got = torch.gather(probability_volume, 1, local.clamp(0, split.local - 1)[:, None])[:, 0]
        return torch.where(mine, got, torch.zeros_like(got))

    prob = at(left0) + at(left1) + at(right0) + at(right1)
    if split is not None:
        prob = split.all_sum(prob)
    return prob[..., None]


def prob2depth(prob_volume: torch.Tensor, depth_num: int, depth_start: torch.Tensor,
               depth_interval: torch.Tensor, out_prob_map: bool = False, impl: str = "auto",
               split=None):
    """Soft-argmin: softmax(-cost) over depth, expectation over the sweep values.

    prob_volume: (B, D, h, w) raw cost; depth_start/interval: (B,).
    Returns depth (B, h, w, 1) [+ confidence (B, h, w, 1)].
    Without the confidence map the work goes to ops.softargmin (`impl` picks the CUDA
    kernel or the plain version); the confidence path needs the full softmax volume
    and stays a torch formula (over a split: the global max, then the softmax's
    normaliser and the expectation summed over the depth group).
    """
    if not out_prob_map:
        return softargmin(prob_volume, depth_num, depth_start, depth_interval, impl=impl,
                          split=split)
    if split is None:
        probability = torch.softmax(-prob_volume.to(torch.float32), dim=1)
        s = sweep(depth_num, depth_start, depth_interval)
        depth = torch.sum(s[:, :, None, None] * probability, dim=1)[..., None]
    else:
        v = -prob_volume.to(torch.float32)
        # the max only steadies the exponent: the softmax does not depend on it
        ref = finite_or_zero(split.all_max(v.amax(dim=1)))
        e = torch.exp(v - ref[:, None])
        probability = e / split.all_sum(e.sum(dim=1))[:, None]
        s = sweep(v.shape[1], depth_start, depth_interval, split.offset)
        depth = split.all_sum(torch.sum(s[:, :, None, None] * probability, dim=1))[..., None]
    return depth, probability_map(probability, depth, depth_start, depth_interval, split)


def _row_tile(total: int, target: int = 128) -> int:
    """Largest divisor of `total` that is <= target (>=1)."""
    for t in range(min(target, total), 0, -1):
        if total % t == 0:
            return t
    return 1


def prob2depth_upsample(prob_volume: torch.Tensor, depth_num: int, depth_start: torch.Tensor,
                        depth_interval: torch.Tensor, out_prob_map: bool = False,
                        up_scale: int = 4, impl: str = "auto", split=None):
    """Soft-argmin at native and up_scale-upsampled resolution.

    Returns (depth, depth_up[, prob, prob_up]). The W-resize is shared; the H-resize
    and soft-argmin run per tile of output rows (120-row tiles at 480 output rows).
    """
    B, D, h, w = prob_volume.shape
    Hout, Wout = h * up_scale, w * up_scale
    pv = prob_volume.to(torch.float32)
    pv_w = torch.einsum("qw,bdhw->bdhq", _matrix(Wout, w, pv.device), pv)  # (B, D, h, Wout)
    Ah = _matrix(Hout, h, pv.device)
    tile = _row_tile(Hout)
    outs = [
        prob2depth(torch.einsum("th,bdhq->bdtq", Ah[r:r + tile], pv_w),
                   depth_num, depth_start, depth_interval, out_prob_map, impl=impl, split=split)
        for r in range(0, Hout, tile)
    ]
    if out_prob_map:
        depth, prob = prob2depth(prob_volume, depth_num, depth_start, depth_interval, True,
                                 impl=impl, split=split)
        return (depth, torch.cat([o[0] for o in outs], dim=1),
                prob, torch.cat([o[1] for o in outs], dim=1))
    depth = prob2depth(prob_volume, depth_num, depth_start, depth_interval, impl=impl, split=split)
    return depth, torch.cat(outs, dim=1)


def final_depths(prob_agg2: torch.Tensor, cfg, depth_start: torch.Tensor,
                 depth_interval: torch.Tensor, out_prob_map: bool, upsample: bool,
                 split=None) -> dict:
    """Stage 4's soft-argmin under a PipelineConfig `cfg`: depth (B, h, w, 1) in sweep
    space, with upsample depth_up (B, 4h, 4w, 1), with out_prob_map confidence (and
    confidence_up)."""
    D, impl = cfg.max_d, cfg.softargmin_impl
    if upsample:
        res = prob2depth_upsample(prob_agg2, D, depth_start, depth_interval,
                                  out_prob_map=out_prob_map, impl=impl, split=split)
        keys = ("depth", "depth_up", "confidence", "confidence_up") if out_prob_map else (
            "depth", "depth_up")
        return dict(zip(keys, res))
    if out_prob_map:
        depth, conf = prob2depth(prob_agg2, D, depth_start, depth_interval, True, impl=impl,
                                 split=split)
        return {"depth": depth, "confidence": conf}
    return {"depth": prob2depth(prob_agg2, D, depth_start, depth_interval, impl=impl, split=split)}
