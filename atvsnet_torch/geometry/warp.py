"""Image warping for the plane sweep (atvsnet_tpu/geometry/warp.py).

Sampling semantics of the reference's `interpolate` (homography_warping.py:31-104),
which torch.nn.functional.grid_sample does not share:
  * texture coordinates: 0.5 is the center of pixel 0, so coordinates shift by -0.5;
  * the valid window is [0, W-1) x [0, H-1) after the shift; NaN or inf is invalid;
  * an invalid bilinear sample is exactly 0 (all four corner weights vanish);
  * an invalid nearest sample is NOT zeroed: it reads pixel (0, 0);
  * nearest rounds half to even (tf.round).

The sampling math lives once, in `_sample`, under every warp here and the visual hull; the
JAX package keeps two copies of it only to steer TPU layouts. On CUDA tensors it is one
hand-written kernel (ops/plane_sweep.py, csrc/plane_sweep.cu) that gives the bits of its
plain version, ops.plane_sweep.sample_torch, which CPU tensors take.

PipelineConfig.warp_quant="int8" stores plane_sweep_warp's bilinear volumes on an int8
lattice (`quantize_warp`). Nearest sweeps never quantize, and neither does the fused
bilinear-and-nearest sweep of the refinement (plane_sweep_warp_with_nearest), as in the
JAX package, whose _maybe_quant_warp only plane_sweep_warp's bilinear branch calls.

The projective matmuls run in full fp32 with TF32 off (ops.fp32_passes.tf32), as the JAX
package pins them to HIGHEST whatever fp32_precision says.
"""

from __future__ import annotations

import torch

from atvsnet_torch.geometry.cameras import split_cam
from atvsnet_torch.geometry.homography import pixel_grid
from atvsnet_torch.ops import plane_sweep
from atvsnet_torch.ops.fp32_passes import tf32
from atvsnet_torch.utils.profiling import TRACER


def _sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            bilinear: bool = True, nearest_channels: slice | None = None):
    """Sample image (B, H, W, C) at texture coords x, y (B, P).

    Returns (bilinear (B, P, C) or None, nearest (B, P, Cn) or None, valid (B, P)).
    `nearest_channels` selects the channels of the nearest sample; None skips it.
    CUDA tensors take the plane-sweep kernel (under autograd), CPU tensors its plain
    version, ops.plane_sweep.sample_torch; both give the same bits.
    """
    if image.device.type == "cuda":
        return plane_sweep.PlaneSweepFunction.apply(image, x, y, bilinear, nearest_channels,
                                                    plane_sweep.plane_sweep_cuda)
    return plane_sweep.sample_torch(image, x, y, bilinear, nearest_channels)


def interpolate(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                method: str = "bilinear", output_mask: bool = False):
    """Sample `image` (B, H, W, C) at texture coords x, y (B, P) -> (B, P, C) [+ valid (B, P)]."""
    if method == "nearest":
        _, out, valid = _sample(image, x, y, bilinear=False, nearest_channels=slice(None))
    elif method == "bilinear":
        out, _, valid = _sample(image, x, y)
    else:
        raise ValueError(f"method must be bilinear|nearest, got {method!r}")
    return (out, valid) if output_mask else out


@tf32(False)
def _homography_coords(homography: torch.Tensor, height: int, width: int):
    """homography (..., 3, 3) -> x, y sample coords (..., H*W)."""
    grid = pixel_grid(height, width, device=homography.device)
    warped = homography.to(torch.float32) @ grid
    denom = warped[..., 2, :]
    # division-by-zero guard of the reference's homography warp (homography_warping.py:251-252)
    denom = denom + torch.where(denom == 0.0, 1e-7, 0.0)
    return warped[..., 0, :] / denom, warped[..., 1, :] / denom


def homography_warp(image: torch.Tensor, homography: torch.Tensor, method: str = "bilinear",
                    output_mask: bool = False):
    """Warp image (B, H, W, C) by one homography (B, 3, 3) per sample: each output pixel p
    samples image at H p (reference homography_warping.py:230-271).

    Returns (B, H, W, C) [+ the boolean validity mask (B, H, W, 1)].
    """
    B, H, W, C = image.shape
    x, y = _homography_coords(homography, H, W)            # (B, HW)
    out, mask = interpolate(image, x, y, method=method, output_mask=True)
    out = out.reshape(B, H, W, C)
    return (out, mask.reshape(B, H, W, 1)) if output_mask else out


def quantize_warp(out: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """The int8 round trip of a bilinear plane-sweep volume out (B, D, H, W, C) warped from
    image (B, H, W, C) (atvsnet_tpu/geometry/warp.py:_maybe_quant_warp).

    The scale is per (sample, channel), max|image| / 127 + 1e-12 over the source map: the
    bilinear corner weights are convex and an invalid sample is 0, so the volume never
    leaves [-127, 127] steps and a zero stays zero. fp32 arithmetic, round half to even,
    the result in out's dtype; inference only (round() has no gradient).

    While a profiler records (utils.profiling.TRACER), the round trip is the span
    `quant.warp` (chain=False, with CUDA events on a CUDA out, as nn.layers.quantize_act's
    `quant.act`) and adds the volume's elements to the counter `quant.warp.elements`.
    """
    with TRACER.span("quant.warp", device=out.device, chain=False):
        TRACER.count("quant.warp.elements", out.numel())
        divisor = torch.full((), 127.0, dtype=torch.float32, device=image.device)
        s = (image.to(torch.float32).abs().amax(dim=(1, 2), keepdim=True) / divisor
             + 1e-12)[:, None]                             # (B, 1, 1, 1, C)
        q = torch.clamp(torch.round(out.to(torch.float32) / s), -127.0, 127.0).to(torch.int8)
        return (q.to(torch.float32) * s).to(out.dtype)


def plane_sweep_warp(image: torch.Tensor, homographies: torch.Tensor,
                     method: str = "bilinear", output_mask: bool = False,
                     quant: str = "none"):
    """Warp (B, H, W, C) by all D plane homographies (B, D, 3, 3).

    Returns (B, D, H, W, C) [+ mask (B, D, H, W, 1)]. quant="int8" (PipelineConfig.
    warp_quant) stores a bilinear volume on quantize_warp's lattice; a nearest one never.
    """
    if quant not in ("none", "int8"):
        raise ValueError(f"warp_quant={quant!r}: expected one of none|int8")
    B, H, W, C = image.shape
    D = homographies.shape[1]
    x, y = _homography_coords(homographies, H, W)          # (B, D, HW)
    out, mask = interpolate(image, x.reshape(B, -1), y.reshape(B, -1),
                            method=method, output_mask=True)
    out = out.reshape(B, D, H, W, C)
    if quant == "int8" and method == "bilinear":
        out = quantize_warp(out, image)
    return (out, mask.reshape(B, D, H, W, 1)) if output_mask else out


def plane_sweep_warp_with_nearest(image: torch.Tensor, homographies: torch.Tensor,
                                  nearest_slice: slice | None = None):
    """Bilinear AND nearest plane-sweep warps of one source from one set of coordinates.

    Returns (bilinear (B,D,H,W,C), nearest (B,D,H,W,Cn), mask (B,D,H,W,1));
    `nearest_slice` restricts the nearest output to those source channels.
    """
    B, H, W, C = image.shape
    D = homographies.shape[1]
    x, y = _homography_coords(homographies, H, W)
    bil, near, valid = _sample(
        image, x.reshape(B, -1), y.reshape(B, -1),
        nearest_channels=slice(None) if nearest_slice is None else nearest_slice,
    )
    return (
        bil.reshape(B, D, H, W, C),
        near.reshape(B, D, H, W, -1),
        valid.reshape(B, D, H, W, 1),
    )


@tf32(False)
def _relative_projection(left_cam: torch.Tensor, right_cam: torch.Tensor):
    """M = K_r R_r R_l^T K_l^{-1} (B,3,3) and v = K_r (R_r c_l + t_r) (B,3,1).

    A left-frame pixel p at depth z projects into the right frame as z' p' = M (z p) + v.
    """
    f32 = torch.float32
    K_l, R_l, t_l = split_cam(left_cam.to(f32))
    K_r, R_r, t_r = split_cam(right_cam.to(f32))
    # inv_ex: linalg.inv's inverse without its check of the factorization's info, which
    # waits for the device and so cannot be captured into a CUDA graph
    K_l_inv = torch.linalg.inv_ex(K_l).inverse
    R_l_T = R_l.transpose(-1, -2)
    c_l = -(R_l_T @ t_l)
    M = (K_r @ R_r) @ (R_l_T @ K_l_inv)
    v = K_r @ (R_r @ c_l) + K_r @ t_r
    return M, v


@tf32(False)
def warp_by_depth(input_image: torch.Tensor, left_cam: torch.Tensor, right_cam: torch.Tensor,
                  depth_image: torch.Tensor, inverse_depth: bool = True,
                  method: str = "bilinear", output_mask: bool = False):
    """Warp the right-camera image (B, H, W, C) to the left camera given a left depth map
    (B, H, W, 1): coords = M p + v * s(d), s(d) = d for inverse depth, 1/d otherwise.

    Unlike the homography warp there is no division guard (reference
    homography_warping.py:108-176 has none either).
    """
    B, H, W, C = input_image.shape
    M, v = _relative_projection(left_cam, right_cam)
    grid = pixel_grid(H, W, device=input_image.device)
    d = depth_image.reshape(B, 1, H * W).to(torch.float32)
    scale = d if inverse_depth else 1.0 / d
    warped = M @ grid + v * scale                          # (B, 3, HW)
    denom = warped[:, 2, :]
    x = warped[:, 0, :] / denom
    y = warped[:, 1, :] / denom
    out, mask = interpolate(input_image, x, y, method=method, output_mask=True)
    out = out.reshape(B, H, W, C)
    return (out, mask.reshape(B, H, W, 1)) if output_mask else out


@tf32(False)
def transform_depth(left_depth: torch.Tensor, left_cam: torch.Tensor, right_cam: torch.Tensor,
                    inverse_depth: bool = True) -> torch.Tensor:
    """Re-express per-pixel left-camera depths (B, H, W, 1) in the right camera frame.

    Pixels stay in place: each left pixel gets the z-depth its 3D point has in the
    right camera. Non-positive inverse depths map to 0.
    """
    shape = left_depth.shape
    B, H, W = shape[0], shape[1], shape[2]
    d = left_depth.reshape(B, 1, H * W).to(torch.float32)
    if inverse_depth:
        pos = d > 1e-10
        z = torch.where(pos, 1.0 / d.clamp(min=1e-10), 0.0)
    else:
        z = d
    M, v = _relative_projection(left_cam, right_cam)
    grid = pixel_grid(H, W, device=left_depth.device)
    z_out = (M @ (grid * z) + v)[:, 2:3, :]
    if inverse_depth:
        z_out = torch.where(pos, 1.0 / z_out.clamp(min=1e-10), 0.0)
    return z_out.reshape(shape).to(left_depth.dtype)
