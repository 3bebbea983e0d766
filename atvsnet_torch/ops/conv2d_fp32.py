"""fp32 2D convolution, fp32_precision="highest": a hand-written CUDA kernel on Hopper's CUDA
cores (an implicit GEMM in FFMA), its autograd Function and its plain version.

    out[b, oh, ow, co] = bias[co] + sum over (kh, kw, ci) of
        x[b, oh*s - ph + kh*d, ow*s - pw + kw*d, ci] * w[co, ci, kh, kw]

x is float32 (B, H, W, Ci), channel-last as every activation of the port; w is the port's
kernel layout (Co, Ci, kh, kw); `pads` gives the (beg, end) pads of H and W explicitly
(TF-SAME at stride 2 on an even size is (0, 1)); zeros lie outside x. The output is
channel-last (B, Ho, Wo, Co), contiguous.

This is the route of every float32 2D convolution with groups 1 in "highest" (nn.layers.
_padded_conv): the FEM, the shallow FEM and the D-constant 2D halves of conv3d_mixed in CRM
and the refinement. The JAX package leaves them to XLA; the kernel replaces cuDNN, whose
choice of algorithm for them depended on the batch (its FFT algorithm at 5 views). The
CUDA source is atvsnet_torch/csrc/conv2d_fp32.cu (its note gives the design and the bound),
compiled with nvcc on first use into build/atvsnet_torch/libatvsnet_torch_conv2d_fp32.so
and bound with ctypes.

  * `plan` picks the block tile (32, 64 or 128 output channels, from Co) and the path
    ("vector": 16-byte copies of x, which need Ci % 4 == 0 and a 16-byte aligned x;
    "scalar": 4-byte copies) from the shapes alone;
  * `conv2d_fp32_cuda` packs the weights K-major, launches on CUDA tensors only, counts its
    launches (in total, per path in `path_launches`, and per (x shape, w shape, stride,
    rate, pads) in `shape_launches`) and raises on anything it does not take;
  * the rest is ops.fp32_passes' channel-last conv wrapper, shared with ops.conv3d_fp32:
    `Conv2dFp32Function` (its autograd Function; the backward is the "highest" backward of
    pass_conv, aten's with TF32 off, on the same padded operands, so training's gradients
    are what they were), `conv2d_fp32_torch` (the plain version, the call the route made
    before the kernel) and `conv2d_fp32`, which picks by device: the Function for CUDA
    tensors, the plain version for CPU tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from atvsnet_torch.ops.fp32_passes import (  # noqa: F401  (highest_backward: the module's API)
    ChannelLastConvFunction,
    channel_last_conv,
    channel_last_conv_torch,
    check_channel_last_cuda,
    conv_output_shape,
    highest_backward,
    padded_channels_first,
)
from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, CudaLibrary, count_launch, launch_counts

SOURCE = CSRC / "conv2d_fp32.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_conv2d_fp32.so"
TILES = (32, 64, 128)          # output channels per block; the C side's tile index
PATHS = ("vector", "scalar")   # the C side's path index

LIB = CudaLibrary(SOURCE, LIBRARY, {
    "atvsnet_conv2d_fp32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p],
                            ctypes.c_int)})
build = LIB.build
__getattr__ = LIB.module_getattr(__name__)   # build_log

# (B, Ho, Wo, Co) of a conv of a (B, H, W, Ci) input with a (Co, Ci, kh, kw) kernel
output_shape = conv_output_shape
conv2d_fp32_torch = channel_last_conv_torch
Conv2dFp32Function = ChannelLastConvFunction


def takes(w_shape: Sequence[int], stride: int, rate: int) -> bool:
    """Whether the kernel computes a conv of this kernel shape, stride and rate: any 2D one."""
    return len(w_shape) == 4 and stride >= 1 and rate >= 1


def plan(ci: int, co: int, aligned: bool = True) -> dict:
    """The launch's tile (output channels per block: the least of TILES that holds Co, else
    the largest) and path ("vector" where Ci % 4 == 0 and x is 16-byte aligned)."""
    tile = next((t for t in TILES if co <= t), TILES[-1])
    return {"tile": tile, "path": "vector" if ci % 4 == 0 and aligned else "scalar"}


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, kh, kw) -> the kernel's K-major (kh * kw * Ci, Np) matrix, Np = Co rounded up
    to 4 with zero columns past Co: row (kh, kw, ci), column co."""
    co, ci, kh, kw = w.shape
    wk = w.permute(2, 3, 1, 0).reshape(kh * kw * ci, co)
    if co % 4 == 0:
        return wk.contiguous()
    return F.pad(wk, (0, 4 - co % 4))


def implicit_gemm_torch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                        stride: int, rate: int, pads) -> torch.Tensor:
    """The kernel's GEMM in plain PyTorch: A (M, K) gathers x's taps in the kernel's (kh, kw,
    ci) order with zeros outside x, B is packed_weights(w), out = A @ B[:, :Co] + bias. Any
    float dtype; float64 gives the exact sums of float32 operands."""
    B, Ho, Wo, co = output_shape(x.shape, w.shape, stride, rate, pads)
    kh, kw = w.shape[2:]
    (th, bh), (lw, rw) = pads
    xp = F.pad(x, (0, 0, lw, rw, th, bh))
    taps = [xp[:, i * rate:i * rate + (Ho - 1) * stride + 1:stride,
               j * rate:j * rate + (Wo - 1) * stride + 1:stride]
            for i in range(kh) for j in range(kw)]
    a = torch.cat(taps, dim=-1).reshape(B * Ho * Wo, -1)
    out = a @ packed_weights(w.to(x.dtype))[:, :co]
    if b is not None:
        out = out + b.to(x.dtype)
    return out.reshape(B, Ho, Wo, co)


def _launch(x: torch.Tensor, wp: torch.Tensor, bias: Optional[torch.Tensor], w_shape,
            stride: int, rate: int, pads, p: dict) -> torch.Tensor:
    """One launch with plan p on contiguous operands (wp packed); returns the output."""
    B, H, W, ci = x.shape
    co, _, kh, kw = w_shape
    shape = output_shape(x.shape, w_shape, stride, rate, pads)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = LIB().atvsnet_conv2d_fp32(
            x.data_ptr(), wp.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, H, W, ci, shape[1], shape[2], co, wp.shape[1], kh, kw, stride,
            rate, pads[0][0], pads[1][0], TILES.index(p["tile"]), PATHS.index(p["path"]),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv2d_fp32 kernel launch failed for {tuple(x.shape)} with "
                           f"{tuple(w_shape)} at stride {stride}, rate {rate}, pads {pads} "
                           f"({p}): cudaError {err}")
    return out


def conv2d_fp32_cuda(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     stride: int, rate: int, pads) -> torch.Tensor:
    """Pack the weights and launch the CUDA kernel: x (B, H, W, Ci), w (Co, Ci, kh, kw) and b
    (Co,) or None, float32 CUDA tensors on one device -> (B, Ho, Wo, Co), channel-last."""
    check_channel_last_cuda("conv2d_fp32_cuda", x, w, b, stride, rate, pads, takes)
    x = x.contiguous()
    p = plan(x.shape[-1], w.shape[0], aligned=x.data_ptr() % 16 == 0)
    out = _launch(x, packed_weights(w), None if b is None else b.contiguous(), tuple(w.shape),
                  stride, rate, pads, p)
    count_launch(conv2d_fp32_cuda, p["path"],
                 (tuple(x.shape), tuple(w.shape), stride, rate, tuple(pads)))
    return out


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                rate: int, pads) -> torch.Tensor:
    """The kernel (under autograd) for CUDA tensors, the plain version for CPU tensors."""
    return channel_last_conv(x, w, b, stride, rate, pads, conv2d_fp32_cuda)


reset_launch_counts = launch_counts(PATHS, conv2d_fp32_cuda)
