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
  * `Conv2dFp32Function` runs it under autograd; its backward is the "highest" backward of
    ops.fp32_passes.pass_conv (aten's, TF32 off) on the same padded operands, so training's
    gradients are what they were;
  * `conv2d_fp32_torch` is the plain version, the call the route made before the kernel
    (ops.fp32_passes.pass_conv on the padded channel-first view);
  * `conv2d_fp32` picks by device: the Function for CUDA tensors, the plain version for CPU
    tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from atvsnet_torch.ops.fp32_passes import ConvSpec, pass_conv, tf32
from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, nvcc_build

SOURCE = CSRC / "conv2d_fp32.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_conv2d_fp32.so"
TILES = (32, 64, 128)          # output channels per block; the C side's tile index
PATHS = ("vector", "scalar")   # the C side's path index

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build(force: bool = False) -> Path:
    """Compile csrc/conv2d_fp32.cu into LIBRARY unless an up-to-date build exists."""
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
            lib.atvsnet_conv2d_fp32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                                                + [ctypes.c_void_p])
            lib.atvsnet_conv2d_fp32.restype = ctypes.c_int
            _lib = lib
    return _lib


def output_shape(x_shape: Sequence[int], w_shape: Sequence[int], stride: int, rate: int,
                 pads) -> tuple[int, int, int, int]:
    """(B, Ho, Wo, Co) of a conv of a (B, H, W, Ci) input with a (Co, Ci, kh, kw) kernel."""
    B, H, W, _ = x_shape
    co, _, kh, kw = w_shape
    (th, bh), (lw, rw) = pads
    return (B, (H + th + bh - rate * (kh - 1) - 1) // stride + 1,
            (W + lw + rw - rate * (kw - 1) - 1) // stride + 1, co)


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


def padded_channels_first(x: torch.Tensor, pads):
    """The channel-first view of a channel-last x and aten's symmetric padding for explicit
    (beg, end) `pads` per spatial axis: pads that are equal per axis stay aten's argument,
    unequal ones (TF-SAME's) are applied by F.pad first, and the padding is then 0."""
    xc = x.movedim(-1, 1)
    if all(lo == hi for lo, hi in pads):
        return xc, tuple(lo for lo, _ in pads)
    return F.pad(xc, [p for lo, hi in reversed(pads) for p in (lo, hi)]), 0


def conv2d_fp32_torch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                      stride: int, rate: int, pads) -> torch.Tensor:
    """Plain version on any device: pass_conv in "highest" (aten's conv, TF32 off) on the
    padded channel-first view, the route's call before the kernel."""
    xc, padding = padded_channels_first(x, pads)
    return pass_conv(xc, w, "highest", stride, padding, rate, 1, b).movedim(1, -1)


def _check_cuda(name: str, x: torch.Tensor, w: torch.Tensor, b, stride: int, rate: int,
                pads) -> None:
    tensors = [x, w] + ([] if b is None else [b])
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name} takes float32 tensors, got {[t.dtype for t in tensors]}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"{name}: x must be (B, H, W, Ci) and w (Co, Ci, kh, kw), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"{name}: bias must be ({w.shape[0]},), got {tuple(b.shape)}")
    if stride < 1 or rate < 1 or len(pads) != 2 or any(p < 0 for pr in pads for p in pr):
        raise ValueError(f"{name}: stride {stride}, rate {rate} and pads {pads} out of range")
    shape = output_shape(x.shape, w.shape, stride, rate, pads)
    if min(shape) < 1:
        raise ValueError(f"{name}: no output for {tuple(x.shape)} with {tuple(w.shape)}")
    if x.numel() >= 2**31 or shape[0] * shape[1] * shape[2] * shape[3] >= 2**31:
        raise ValueError(f"{name}: tensor too large, {tuple(x.shape)} -> {shape}")


def _launch(x: torch.Tensor, wp: torch.Tensor, bias: Optional[torch.Tensor], w_shape,
            stride: int, rate: int, pads, p: dict) -> torch.Tensor:
    """One launch with plan p on contiguous operands (wp packed); returns the output."""
    B, H, W, ci = x.shape
    co, _, kh, kw = w_shape
    shape = output_shape(x.shape, w_shape, stride, rate, pads)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _library().atvsnet_conv2d_fp32(
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
    _check_cuda("conv2d_fp32_cuda", x, w, b, stride, rate, pads)
    x = x.contiguous()
    p = plan(x.shape[-1], w.shape[0], aligned=x.data_ptr() % 16 == 0)
    out = _launch(x, packed_weights(w), None if b is None else b.contiguous(), tuple(w.shape),
                  stride, rate, pads, p)
    conv2d_fp32_cuda.launches += 1
    conv2d_fp32_cuda.path_launches[p["path"]] += 1
    key = (tuple(x.shape), tuple(w.shape), stride, rate, tuple(pads))
    conv2d_fp32_cuda.shape_launches[key] = conv2d_fp32_cuda.shape_launches.get(key, 0) + 1
    return out


def highest_backward(ctx, g: torch.Tensor) -> tuple:
    """(grad x, grad w, grad b) of a channel-last conv whose forward saved (x, w) and set
    ctx.stride, .rate, .pads and .bias_sizes: pass_conv's "highest" backward (aten's
    convolution_backward, TF32 off) on the padded channel-first operands, the pads then
    dropped from grad x as F.pad's backward drops them. Any number of spatial axes."""
    x, w = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    xc, padding = padded_channels_first(x, ctx.pads)
    spec = ConvSpec.of(x.ndim - 2, ctx.stride, padding, ctx.rate)
    with tf32(False):
        gx, gw, gb = spec.backward(xc, g.movedim(-1, 1), w, [need_x, need_w, need_b],
                                   ctx.bias_sizes)
    if gx is not None:
        if any(lo != hi for lo, hi in ctx.pads):
            gx = gx[(slice(None), slice(None)) + tuple(
                slice(lo, lo + n) for (lo, _), n in zip(ctx.pads, x.shape[1:-1]))]
        gx = gx.movedim(1, -1)
    return gx, gw, gb


class Conv2dFp32Function(torch.autograd.Function):
    """The kernel's forward; the backward is pass_conv's "highest" backward (aten's
    convolution_backward with TF32 off) on the same padded channel-first operands."""

    @staticmethod
    def forward(ctx, x, w, b, stride, rate, pads):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.rate, ctx.pads = stride, rate, pads
        ctx.bias_sizes = None if b is None else list(b.shape)
        return conv2d_fp32_cuda(x, w, b, stride, rate, pads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return highest_backward(ctx, g) + (None, None, None)


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
                rate: int, pads) -> torch.Tensor:
    """The kernel (under autograd) for CUDA tensors, the plain version for CPU tensors."""
    pads = tuple(tuple(p) for p in pads)
    if x.device.type == "cuda":
        return Conv2dFp32Function.apply(x, w, b, stride, rate, pads)
    return conv2d_fp32_torch(x, w, b, stride, rate, pads)


def reset_launch_counts() -> None:
    """Set the kernel's launch counts (total, per path and per shape) to 0."""
    conv2d_fp32_cuda.launches = 0
    conv2d_fp32_cuda.path_launches = dict.fromkeys(PATHS, 0)
    conv2d_fp32_cuda.shape_launches = {}


reset_launch_counts()
