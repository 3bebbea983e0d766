"""fp32 3D convolution, fp32_precision="highest": a hand-written CUDA kernel on Hopper's CUDA
cores (a direct convolution in FFMA), its autograd Function and its plain version.

    out[b, od, oh, ow, co] = bias[co] + sum over (kd, kh, kw, ci) of
        x[b, od*s - pd + kd, oh*s - ph + kh, ow*s - pw + kw, ci] * w[co, ci, kd, kh, kw]

x is float32 (B, D, H, W, Ci), channel-last as every volume of the port; w is the port's
kernel layout (Co, Ci, 3, 3, 3); `pads` gives the (beg, end) pads of D, H and W explicitly
(TF-SAME at stride 2 on an even size is (0, 1); a depth split's halo'd block has (0, 0) on
D); zeros lie outside x. The output is channel-last (B, Do, Ho, Wo, Co), contiguous.

This is the route of every float32 3D convolution with groups 1 in "highest"
(nn.layers._padded_conv): CRM's and the refinement's volume convs, AAM's [unique | shared]
conv and the probability convs, all 3x3x3 at rate 1 and stride 1 or 2. The JAX package leaves
them to XLA; the kernel replaces cuDNN, which ran them with TF32 off at ~9% of the fp32 FFMA
peak. The CUDA source is atvsnet_torch/csrc/conv3d_fp32.cu (its note gives the design and
the bound), compiled with nvcc on first use into
build/atvsnet_torch/libatvsnet_torch_conv3d_fp32.so and bound with ctypes.

  * `plan` picks the path ("vector": 16-byte copies of 4 channels, which need Ci % 4 == 0
    and a 16-byte aligned x; "scalar": 4-byte copies), the output channels a thread holds
    (`tn`), its output planes (`planes`) and the stages of the copy ring from (Ci, Co,
    stride) alone;
  * `conv3d_fp32_cuda` launches on CUDA tensors only, counts its launches (in total, per
    path in `path_launches`, and per (x shape, w shape, stride, pads) in `shape_launches`)
    and raises on anything it does not take;
  * the rest is ops.fp32_passes' channel-last conv wrapper, shared with ops.conv2d_fp32:
    `Conv3dFp32Function` (its autograd Function; the backward is the "highest" backward of
    pass_conv, aten's with TF32 off, on the same padded operands, so training's gradients
    are what they were), `conv3d_fp32_torch` (the plain version, the call the route made
    before the kernel) and `conv3d_fp32`, which picks by device: the Function for CUDA
    tensors, the plain version for CPU tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from atvsnet_torch.ops.fp32_passes import (
    ChannelLastConvFunction,
    channel_last_conv,
    channel_last_conv_torch,
    check_channel_last_cuda,
    conv_output_shape,
)
from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, CudaLibrary, count_launch, launch_counts

SOURCE = CSRC / "conv3d_fp32.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_conv3d_fp32.so"
PATHS = ("vector", "scalar")   # the C side's path index
BLOCK = (16, 8)                # output columns (w) x rows (h) of a block, one per thread
KERNEL = (3, 3, 3)             # the only kernel size it takes, at rate 1 and stride 1 or 2

LIB = CudaLibrary(SOURCE, LIBRARY, {
    "atvsnet_conv3d_fp32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_void_p],
                            ctypes.c_int)})
build = LIB.build
__getattr__ = LIB.module_getattr(__name__)   # build_log

conv3d_fp32_torch = channel_last_conv_torch
Conv3dFp32Function = ChannelLastConvFunction


def takes(w_shape: Sequence[int], stride: int, rate: int) -> bool:
    """Whether the kernel computes a conv of this kernel shape, stride and rate."""
    return tuple(w_shape[2:]) == KERNEL and rate == 1 and stride in (1, 2)


def output_shape(x_shape: Sequence[int], w_shape: Sequence[int], stride: int,
                 pads) -> tuple[int, int, int, int, int]:
    """(B, Do, Ho, Wo, Co) of a conv of a (B, D, H, W, Ci) input with a (Co, Ci, kd, kh, kw)
    kernel at rate 1."""
    return conv_output_shape(x_shape, w_shape, stride, 1, pads)


def plan(ci: int, co: int, stride: int, aligned: bool = True) -> dict:
    """The launch's plan from (Ci, Co, stride) alone: the path ("vector" where Ci % 4 == 0
    and x is 16-byte aligned, else "scalar"); `tn` output channels a thread (1 for Co = 1 at
    stride 1; 16 where Co is a multiple of 16 and Ci * Co <= 512; else 8); `planes`, the
    output planes a thread walks along D (2 at stride 2; at stride 1 8, or 4 with tn 16,
    halved while Ci * Co > 512 down to 2, so that the deep levels' few voxels still make
    enough blocks); `stages` of the copy ring (2 at stride 1, 1 at stride 2, whose brick
    is ~8x its output tile: blocks then overlap each other's copies)."""
    tn = 1 if co == 1 and stride == 1 else 16 if co % 16 == 0 and ci * co <= 512 else 8
    if stride == 2:
        planes, stages = 2, 1
    else:
        planes, stages, work = (8 if tn <= 8 else 4), 2, ci * co
        while work > 512 and planes > 2:
            planes, work = planes // 2, work // 4
    return {"path": "vector" if ci % 4 == 0 and aligned else "scalar", "tn": tn,
            "planes": planes, "stages": stages}


def _launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
            pads, p: dict) -> torch.Tensor:
    """One launch with plan p on contiguous operands; returns the output."""
    B, D, H, W, ci = x.shape
    shape = output_shape(x.shape, w.shape, stride, pads)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = LIB().atvsnet_conv3d_fp32(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, D, H, W, ci, *shape[1:], stride, pads[0][0], pads[1][0],
            pads[2][0], PATHS.index(p["path"]), p["tn"], p["planes"], p["stages"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_fp32 kernel launch failed for {tuple(x.shape)} with "
                           f"{tuple(w.shape)} at stride {stride}, pads {pads} ({p}): "
                           f"cudaError {err}")
    return out


def conv3d_fp32_cuda(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     stride: int, rate: int, pads) -> torch.Tensor:
    """Launch the CUDA kernel: x (B, D, H, W, Ci), w (Co, Ci, 3, 3, 3) and b (Co,) or None,
    float32 CUDA tensors on one device -> (B, Do, Ho, Wo, Co), channel-last."""
    check_channel_last_cuda("conv3d_fp32_cuda", x, w, b, stride, rate, pads, takes)
    x = x.contiguous()
    p = plan(x.shape[-1], w.shape[0], stride, aligned=x.data_ptr() % 16 == 0)
    out = _launch(x, w.contiguous(), None if b is None else b.contiguous(), stride, pads, p)
    count_launch(conv3d_fp32_cuda, p["path"], (tuple(x.shape), tuple(w.shape), stride, tuple(pads)))
    return out


def conv3d_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                rate: int, pads) -> torch.Tensor:
    """The kernel (under autograd) for CUDA tensors, the plain version for CPU tensors."""
    return channel_last_conv(x, w, b, stride, rate, pads, conv3d_fp32_cuda)


reset_launch_counts = launch_counts(PATHS, conv3d_fp32_cuda)
