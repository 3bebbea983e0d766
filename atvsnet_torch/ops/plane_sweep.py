"""The plane-sweep sampler: geometry.warp._sample as a hand-written CUDA kernel for Hopper,
its autograd Function and its plain version.

    valid[b, p]    = x - 0.5, y - 0.5 finite and inside [0, W-1) x [0, H-1)
    bilinear[b, p] = the 4-corner bilinear sample of image[b] at (x - 0.5, y - 0.5), 0 if invalid
    nearest[b, p]  = image[b] at the nearest pixel (round half to even), channels
                     `nearest_channels`; pixel (0, 0) if invalid

image is (B, H, W, C) channel-last, float32 or bfloat16; x, y are (B, P) texture coordinates.
`sample_torch` is the plain version, aten's chain of index computations, four index_select
gathers and their weighted sum; it is the sampler's arithmetic as the JAX package's
atvsnet_tpu/geometry/warp.py has it (see geometry/warp.py for the semantics). The kernel,
atvsnet_torch/csrc/plane_sweep.cu (its note gives the design and the bound), repeats that
arithmetic operation by operation and gives the plain version's bits on the card in both
dtypes; it is compiled with nvcc on first use into
build/atvsnet_torch/libatvsnet_torch_plane_sweep.so and bound with ctypes.

The JAX package has no Pallas kernel here (Mosaic could not lower in-kernel gathers, so its
sampler stayed on XLA): the kernel replaces aten's chain, as the fp32 conv kernels replace
cuDNN.

  * `plan` picks the launch from what the input shows: the kind ("bilinear",
    "bilinear_nearest", "nearest": which outputs are asked for) and the path ("vector":
    16-byte loads and stores of a thread's 4 fp32 or 8 bf16 channels, where C and the
    nearest slice's start and width are multiples of that and the image is 16-byte aligned;
    "scalar": the same channels a thread with element loads and stores, anything else);
  * `plane_sweep_cuda` launches on CUDA tensors only and counts its launches (in total, per
    "<kind>.<path>" in `path_launches`, and per (image shape, P, dtype, kind, nearest
    channels) in `shape_launches`); it raises on anything it does not take;
  * `PlaneSweepFunction` is its autograd Function: the backward is the vjp of the plain
    version recomputed on the saved image and coordinates, so gradients (for the image, and
    for x and y where a depth map feeds the coordinates, as in training) are what they
    were before the kernel.
geometry.warp._sample picks by device: the Function for CUDA tensors, the plain version for
CPU tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, CudaLibrary, count_launch, launch_counts

SOURCE = CSRC / "plane_sweep.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_plane_sweep.so"
KINDS = ("bilinear", "bilinear_nearest", "nearest")
PATHS = tuple(f"{kind}.{path}" for kind in KINDS for path in ("vector", "scalar"))
DTYPES = (torch.float32, torch.bfloat16)   # the C side's dtype index
VECTOR_BYTES = 16

LIB = CudaLibrary(SOURCE, LIBRARY, {
    "atvsnet_plane_sweep": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int)})
build = LIB.build
__getattr__ = LIB.module_getattr(__name__)   # build_log


def sample_torch(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 bilinear: bool = True, nearest_channels: slice | None = None):
    """Sample image (B, H, W, C) at texture coords x, y (B, P).

    Returns (bilinear (B, P, C) or None, nearest (B, P, Cn) or None, valid (B, P)).
    `nearest_channels` selects the channels of the nearest sample; None skips it.
    """
    B, H, W, C = image.shape
    x = x.to(torch.float32) - 0.5
    y = y.to(torch.float32) - 0.5
    valid = (torch.isfinite(x) & torch.isfinite(y)
             & (x >= 0) & (y >= 0) & (x < W - 1) & (y < H - 1))
    # zero invalid coordinates before floor/round so the integer casts stay defined
    x = torch.where(valid, x, 0.0)
    y = torch.where(valid, y, 0.0)

    flat = image.reshape(B * H * W, C)
    base = (torch.arange(B, device=image.device) * (H * W))[:, None]

    def gather(table, iy, ix):
        rows = (iy * W + ix + base).reshape(-1)
        return table.index_select(0, rows).reshape(B, -1, table.shape[-1])

    nearest = None
    if nearest_channels is not None:
        nearest = gather(flat[:, nearest_channels],
                         torch.round(y).long(), torch.round(x).long())
    if not bilinear:
        return None, nearest, valid

    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    # invalid samples get x1 = y1 = 0 (= x = x0 = y0), so all four weights vanish
    # and the output is exactly 0, as the reference's mask-multiply makes it
    x1 = torch.where(valid, x0 + 1, 0)
    y1 = torch.where(valid, y0 + 1, 0)
    x0 = x0.clamp(0, W - 1)
    y0 = y0.clamp(0, H - 1)
    x0f, x1f, y0f, y1f = (v.to(torch.float32) for v in (x0, x1, y0, y1))
    wa = ((y1f - y) * (x1f - x))[..., None].to(image.dtype)
    wb = ((y1f - y) * (x - x0f))[..., None].to(image.dtype)
    wc = ((y - y0f) * (x1f - x))[..., None].to(image.dtype)
    wd = ((y - y0f) * (x - x0f))[..., None].to(image.dtype)
    x1 = x1.clamp(max=W - 1)
    y1 = y1.clamp(max=H - 1)
    out = (wa * gather(flat, y0, x0) + wb * gather(flat, y0, x1)
           + wc * gather(flat, y1, x0) + wd * gather(flat, y1, x1))
    return out, nearest, valid


def nearest_range(nearest_channels: slice | None, channels: int) -> Optional[tuple[int, int]]:
    """(first channel, count) of a nearest slice of `channels`, None for no nearest sample;
    raises for a slice the kernel does not take (a step other than 1, or no channel)."""
    if nearest_channels is None:
        return None
    picked = range(channels)[nearest_channels]
    if len(picked) == 0 or picked.step != 1:
        raise ValueError(f"the plane-sweep kernel takes a nearest slice of consecutive channels,"
                         f" got {nearest_channels} of {channels}")
    return picked.start, len(picked)


def plan(channels: int, dtype: torch.dtype, bilinear: bool, nearest: Optional[tuple[int, int]],
         aligned: bool = True) -> dict:
    """The launch's plan from the input alone: the kind (which outputs are asked for) and the
    path ("vector" where C and the nearest slice's start and width are multiples of a
    16-byte vector of `dtype` and the image is 16-byte aligned, else "scalar")."""
    kind = ("bilinear_nearest" if bilinear and nearest else "bilinear" if bilinear
            else "nearest")
    width = VECTOR_BYTES // torch.empty((), dtype=dtype).element_size()
    spans = (channels,) + (tuple(nearest) if nearest else ())
    path = "vector" if aligned and all(v % width == 0 for v in spans) else "scalar"
    return {"kind": kind, "path": path}


def check_cuda(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise unless the kernel takes these operands: CUDA tensors on one device, image
    (B, H, W, C) float32 or bfloat16, x and y (B, P) of one shape."""
    tensors = (image, x, y)
    if any(t.device.type != "cuda" or t.device != image.device for t in tensors):
        raise ValueError(f"plane_sweep_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if image.dtype not in DTYPES:
        raise ValueError(f"plane_sweep_cuda takes a float32 or bfloat16 image, got {image.dtype}")
    if image.dim() != 4 or x.dim() != 2 or x.shape != y.shape or x.shape[0] != image.shape[0]:
        raise ValueError(f"plane_sweep_cuda: image must be (B, H, W, C) and x, y (B, P), got "
                         f"{tuple(image.shape)}, {tuple(x.shape)}, {tuple(y.shape)}")
    if not x.is_floating_point() or not y.is_floating_point():
        raise ValueError(f"plane_sweep_cuda: float coordinates, got {x.dtype}, {y.dtype}")


def _launch(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor, bilinear: bool,
            nearest: Optional[tuple[int, int]], p: dict):
    """One launch with plan p on contiguous operands (x, y float32); returns
    (bilinear or None, nearest or None, valid)."""
    B, H, W, C = image.shape
    P = x.shape[1]
    out = torch.empty((B, P, C), device=image.device, dtype=image.dtype) if bilinear else None
    c0, cn = nearest if nearest else (0, 0)
    near = torch.empty((B, P, cn), device=image.device, dtype=image.dtype) if nearest else None
    valid = torch.empty((B, P), device=image.device, dtype=torch.bool)
    with torch.cuda.device(image.device):
        err = LIB().atvsnet_plane_sweep(
            image.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if out is None else out.data_ptr(), None if near is None else near.data_ptr(),
            valid.data_ptr(), B, H, W, C, P, c0, cn, int(bilinear), DTYPES.index(image.dtype),
            ("vector", "scalar").index(p["path"]), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"plane_sweep kernel launch failed for {tuple(image.shape)} "
                           f"{image.dtype} at {tuple(x.shape)} ({p}, nearest {nearest}): "
                           f"cudaError {err}")
    return out, near, valid


def plane_sweep_cuda(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     bilinear: bool = True, nearest_channels: slice | None = None):
    """Launch the CUDA kernel: `sample_torch`'s outputs from image (B, H, W, C) float32 or
    bfloat16 and coordinates x, y (B, P), CUDA tensors on one device."""
    check_cuda(image, x, y)
    nearest = nearest_range(nearest_channels, image.shape[-1])
    if not bilinear and nearest is None:
        raise ValueError("plane_sweep_cuda: neither a bilinear nor a nearest sample asked for")
    image = image.contiguous()
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    p = plan(image.shape[-1], image.dtype, bilinear, nearest,
             aligned=image.data_ptr() % VECTOR_BYTES == 0)
    result = _launch(image, x, y, bilinear, nearest, p)
    count_launch(plane_sweep_cuda, f"{p['kind']}.{p['path']}",
                 (tuple(image.shape), x.shape[1], str(image.dtype).replace("torch.", ""),
                  p["kind"], nearest))
    return result


class PlaneSweepFunction(torch.autograd.Function):
    """The kernel's forward, `launch(image, x, y, bilinear, nearest_channels)`; the backward
    is the vjp of `sample_torch` recomputed on the saved image, x and y, so training's
    gradients are what they were before the kernel. The mask has no gradient, and the nearest
    sample one only through the image."""

    @staticmethod
    def forward(ctx, image, x, y, bilinear, nearest_channels, launch):
        ctx.save_for_backward(image, x, y)
        ctx.bilinear, ctx.nearest_channels = bilinear, nearest_channels
        out, near, valid = launch(image, x, y, bilinear, nearest_channels)
        ctx.mark_non_differentiable(valid)
        if near is not None and not ctx.needs_input_grad[0]:
            ctx.mark_non_differentiable(near)   # rounded coordinates carry no gradient
        return out, near, valid

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_near, g_valid):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out, near, _ = sample_torch(*leaves, ctx.bilinear, ctx.nearest_channels)
            pairs = [(o, g) for o, g in ((out, g_out), (near, g_near))
                     if o is not None and g is not None and o.requires_grad]
            wanted = [t for t, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                             [g for _, g in pairs], allow_unused=True)
                         if pairs and wanted else [None] * len(wanted))
        return tuple(next(grads) if need else None for need in needs) + (None,) * 3


reset_launch_counts = launch_counts(PATHS, plane_sweep_cuda)
