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
  * `Conv3dFp32Function` runs it under autograd; its backward is the "highest" backward of
    ops.fp32_passes.pass_conv (aten's, TF32 off) on the same padded operands, so training's
    gradients are what they were;
  * `conv3d_fp32_torch` is the plain version, the call the route made before the kernel
    (ops.fp32_passes.pass_conv on the padded channel-first view);
  * `conv3d_fp32` picks by device: the Function for CUDA tensors, the plain version for CPU
    tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from atvsnet_torch.ops.conv2d_fp32 import conv2d_fp32_torch, highest_backward
from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, nvcc_build

SOURCE = CSRC / "conv3d_fp32.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_conv3d_fp32.so"
PATHS = ("vector", "scalar")   # the C side's path index
BLOCK = (16, 8)                # output columns (w) x rows (h) of a block, one per thread
KERNEL = (3, 3, 3)             # the only kernel size it takes, at rate 1 and stride 1 or 2

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build(force: bool = False) -> Path:
    """Compile csrc/conv3d_fp32.cu into LIBRARY unless an up-to-date build exists."""
    global build_log
    library, log = nvcc_build(SOURCE, LIBRARY, force)
    if log is not None:
        build_log = log
    return library


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            # pointers and the stream as c_void_p: ctypes would otherwise cut them to 32 bits
            lib.atvsnet_conv3d_fp32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 17
                                                + [ctypes.c_void_p])
            lib.atvsnet_conv3d_fp32.restype = ctypes.c_int
            _lib = lib
    return _lib


def takes(w_shape: Sequence[int], stride: int, rate: int) -> bool:
    """Whether the kernel computes a conv of this kernel shape, stride and rate."""
    return tuple(w_shape[2:]) == KERNEL and rate == 1 and stride in (1, 2)


def output_shape(x_shape: Sequence[int], w_shape: Sequence[int], stride: int,
                 pads) -> tuple[int, int, int, int, int]:
    """(B, Do, Ho, Wo, Co) of a conv of a (B, D, H, W, Ci) input with a (Co, Ci, kd, kh, kw)
    kernel at rate 1."""
    spatial = tuple((n + lo + hi - k) // stride + 1
                    for n, (lo, hi), k in zip(x_shape[1:4], pads, w_shape[2:]))
    return (x_shape[0],) + spatial + (w_shape[0],)


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


# The plain version on any device, the route's call before the kernel: pass_conv in
# "highest" (aten's conv, TF32 off) on the padded channel-first view, which the 2D route's
# plain version is for any number of spatial axes.
conv3d_fp32_torch = conv2d_fp32_torch


def _check_cuda(name: str, x: torch.Tensor, w: torch.Tensor, b, stride: int, rate: int,
                pads) -> None:
    tensors = [x, w] + ([] if b is None else [b])
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name} takes float32 tensors, got {[t.dtype for t in tensors]}")
    if x.dim() != 5 or w.dim() != 5 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"{name}: x must be (B, D, H, W, Ci) and w (Co, Ci, 3, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not takes(w.shape, stride, rate):
        raise ValueError(f"{name} takes a 3x3x3 kernel at rate 1 and stride 1 or 2, got "
                         f"{tuple(w.shape)}, stride {stride}, rate {rate}")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"{name}: bias must be ({w.shape[0]},), got {tuple(b.shape)}")
    if len(pads) != 3 or any(p < 0 for pr in pads for p in pr):
        raise ValueError(f"{name}: pads {pads} out of range")
    shape = output_shape(x.shape, w.shape, stride, pads)
    if min(shape) < 1:
        raise ValueError(f"{name}: no output for {tuple(x.shape)} with {tuple(w.shape)}")
    if x.numel() >= 2**31 or torch.Size(shape).numel() >= 2**31:
        raise ValueError(f"{name}: tensor too large, {tuple(x.shape)} -> {shape}")


def _launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
            pads, p: dict) -> torch.Tensor:
    """One launch with plan p on contiguous operands; returns the output."""
    B, D, H, W, ci = x.shape
    shape = output_shape(x.shape, w.shape, stride, pads)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _library().atvsnet_conv3d_fp32(
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
    _check_cuda("conv3d_fp32_cuda", x, w, b, stride, rate, pads)
    x = x.contiguous()
    p = plan(x.shape[-1], w.shape[0], stride, aligned=x.data_ptr() % 16 == 0)
    out = _launch(x, w.contiguous(), None if b is None else b.contiguous(), stride, pads, p)
    conv3d_fp32_cuda.launches += 1
    conv3d_fp32_cuda.path_launches[p["path"]] += 1
    key = (tuple(x.shape), tuple(w.shape), stride, tuple(pads))
    conv3d_fp32_cuda.shape_launches[key] = conv3d_fp32_cuda.shape_launches.get(key, 0) + 1
    return out


class Conv3dFp32Function(torch.autograd.Function):
    """The kernel's forward; the backward is pass_conv's "highest" backward (aten's
    convolution_backward with TF32 off) on the same padded channel-first operands."""

    @staticmethod
    def forward(ctx, x, w, b, stride, rate, pads):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.rate, ctx.pads = stride, rate, pads
        ctx.bias_sizes = None if b is None else list(b.shape)
        return conv3d_fp32_cuda(x, w, b, stride, rate, pads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return highest_backward(ctx, g) + (None, None, None)


def conv3d_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                rate: int, pads) -> torch.Tensor:
    """The kernel (under autograd) for CUDA tensors, the plain version for CPU tensors."""
    pads = tuple(tuple(p) for p in pads)
    if x.device.type == "cuda":
        return Conv3dFp32Function.apply(x, w, b, stride, rate, pads)
    return conv3d_fp32_torch(x, w, b, stride, rate, pads)


def reset_launch_counts() -> None:
    """Set the kernel's launch counts (total, per path and per shape) to 0."""
    conv3d_fp32_cuda.launches = 0
    conv3d_fp32_cuda.path_launches = dict.fromkeys(PATHS, 0)
    conv3d_fp32_cuda.shape_launches = {}


reset_launch_counts()
