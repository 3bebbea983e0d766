"""int8 3D convolution with int32 accumulation: a hand-written CUDA kernel on Hopper's
tensor cores, and its plain version.

    acc[b, od, oh, ow, co] = sum over (kd, kh, kw, ci) of
        xq[b, od*s - pd + kd, oh*s - ph + kh, ow*s - pw + kw, ci] * wq[co, ci, kd, kh, kw]

xq is int8 (B, D, H, W, Ci), channel-last as every volume of the port; wq is int8 in the
port's kernel layout (Co, Ci, 3, 3, 3); zeros lie outside xq. `pads` gives (lo, hi) per axis
D, H, W explicitly: TF-SAME at stride 2 on an even size is (0, 1), and a depth split's
block, which carries its halo planes, has (0, 0) on D. The output is channel-last (B, Do,
Ho, Wo, Co): the int32 sums when `scale` is None, else out_dtype(fp32(acc) * scale), scale
an fp32 scalar tensor.

This is the convolution of act_quant="int8mxu" (nn.layers.conv with qin=True), where the
JAX package hands int8 operands to XLA's convolution with preferred_element_type=int32
(atvsnet_tpu/nn/layers.py:233-246). The CUDA source is atvsnet_torch/csrc/int8_conv.cu,
compiled with nvcc on first use into build/atvsnet_torch/libatvsnet_torch_int8_conv.so and
bound with ctypes.

  * `conv3d_int8_cuda` launches the kernel on CUDA tensors only, counts its launches (in
    total, and per (B, D, H, W, Ci, Co, stride) in `shape_launches`) and raises on anything
    it does not take: Co above 64, or an input whose patch and weights do not fit in a
    block's shared memory.
  * `conv3d_int8_torch` is the plain version: one float64 F.conv3d of the integer values,
    exact (|acc| < 2^53), cast to int32, and the same epilogue.
  * `conv3d_int8` picks by device: the kernel for CUDA tensors, the plain version for CPU
    tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, nvcc_build

SOURCE = CSRC / "int8_conv.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_int8_conv.so"
OUT_KINDS = {None: 0, torch.float32: 1, torch.bfloat16: 2}   # out_dtype -> the kernel's kind
MAX_CO = 64

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build(force: bool = False) -> Path:
    """Compile csrc/int8_conv.cu into LIBRARY unless an up-to-date build exists."""
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
            lib.atvsnet_conv3d_int8.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                                                + [ctypes.c_void_p])
            lib.atvsnet_conv3d_int8_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
            for fn in (lib.atvsnet_conv3d_int8, lib.atvsnet_conv3d_int8_plan):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def output_shape(x_shape: Sequence[int], co: int, stride: int, pads) -> tuple[int, ...]:
    """(B, Do, Ho, Wo, Co) of a 3x3x3 conv of a (B, D, H, W, Ci) input at `stride` with
    `pads` ((lo, hi) per D, H, W)."""
    B, *spatial, _ = x_shape
    return (B, *((n + lo + hi - 3) // stride + 1 for n, (lo, hi) in zip(spatial, pads)), co)


def packed_weights(wq: torch.Tensor) -> torch.Tensor:
    """The kernel's weight matrix: (round_up(Co, 8), K) int8 with K = round_up(27 * Ci4,
    32), Ci4 = round_up(Ci, 4), and column k = tap * Ci4 + ci for tap = kd * 9 + kh * 3 +
    kw; zero past Co, Ci and the 27 taps."""
    co, ci = wq.shape[:2]
    ci4 = -(-ci // 4) * 4
    k = 27 * ci4
    taps = F.pad(wq.permute(0, 2, 3, 4, 1), (0, ci4 - ci)).reshape(co, k)
    return F.pad(taps, (0, -(-k // 32) * 32 - k, 0, -(-co // 8) * 8 - co)).contiguous()


def _check(name: str, xq: torch.Tensor, wq: torch.Tensor, stride: int, pads, scale,
           out_dtype) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"{name}: xq and wq must be int8, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 5 or wq.dim() != 5 or tuple(wq.shape[2:]) != (3, 3, 3):
        raise ValueError(f"{name}: xq must be (B, D, H, W, Ci) and wq (Co, Ci, 3, 3, 3), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if wq.shape[1] != xq.shape[-1]:
        raise ValueError(f"{name}: wq takes {wq.shape[1]} input channels, xq has {xq.shape[-1]}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    if len(pads) != 3 or any(lo < 0 or hi < 0 for lo, hi in pads):
        raise ValueError(f"{name}: pads must be three (lo, hi) pairs >= 0, got {pads}")
    if min(output_shape(xq.shape, wq.shape[0], stride, pads)) < 1:
        raise ValueError(f"{name}: no output for {tuple(xq.shape)} at stride {stride}, {pads}")
    if (scale is None) != (out_dtype is None) or out_dtype not in OUT_KINDS:
        raise ValueError(f"{name}: give scale with an fp32 or bf16 out_dtype, or neither "
                         f"(int32 out); got out_dtype {out_dtype}")
    if scale is not None and (scale.dtype != torch.float32 or scale.numel() != 1):
        raise ValueError(f"{name}: scale must be one fp32 value, got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def epilogue(acc: torch.Tensor, scale: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    """The kernel's epilogue on the int32 sums: themselves without a scale, else
    out_dtype(fp32(acc) * scale)."""
    return acc if scale is None else (acc.to(torch.float32) * scale).to(out_dtype)


def conv3d_int8_torch(xq: torch.Tensor, wq: torch.Tensor, stride: int, pads,
                      scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """Plain version of conv3d_int8 on any device: the integer sums through a float64
    conv3d (exact), as int32, then the kernel's epilogue."""
    _check("conv3d_int8_torch", xq, wq, stride, pads, scale, out_dtype)
    flat_pads = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    x = F.pad(xq.movedim(-1, 1).to(torch.float64), flat_pads)
    acc = F.conv3d(x, wq.to(torch.float64), stride=stride).movedim(1, -1).to(torch.int32)
    return epilogue(acc.contiguous(), scale, out_dtype)


def launch_plan(x_shape, co: int, stride: int, pads, out_dtype=None) -> dict:
    """The tile and grid the kernel takes for this conv on the current CUDA device:
    tile_w x tile_h output voxels a tile, blocks per SM, grid blocks, shared memory bytes."""
    B, Do, Ho, Wo, _ = output_shape(x_shape, co, stride, pads)
    res = (ctypes.c_int * 5)()
    err = _library().atvsnet_conv3d_int8_plan(B, x_shape[-1], Do, Ho, Wo, co, stride,
                                              OUT_KINDS[out_dtype], res)
    if err != 0:
        raise RuntimeError(f"conv3d_int8: no launch plan for {tuple(x_shape)} -> {co} "
                           f"channels at stride {stride}: cudaError {err}")
    return dict(zip(("tile_w", "tile_h", "blocks_per_sm", "blocks", "smem_bytes"), res))


def conv3d_int8_cuda(xq: torch.Tensor, wq: torch.Tensor, stride: int, pads,
                     scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """Launch the CUDA kernel: xq, wq (and scale) int8 (fp32) contiguous CUDA tensors on one
    device -> the output, channel-last."""
    _check("conv3d_int8_cuda", xq, wq, stride, pads, scale, out_dtype)
    tensors = [xq, wq] + ([] if scale is None else [scale])
    if any(t.device.type != "cuda" or t.device != xq.device for t in tensors):
        raise ValueError(f"conv3d_int8_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not xq.is_contiguous():
        raise ValueError("conv3d_int8_cuda: xq must be contiguous")
    co = wq.shape[0]
    if co > MAX_CO:
        raise ValueError(f"conv3d_int8_cuda takes at most {MAX_CO} output channels, got {co}")
    B, D, H, W, Ci = xq.shape
    shape = output_shape(xq.shape, co, stride, pads)
    if xq.numel() >= 2**31 or shape[0] * shape[1] * shape[2] * shape[3] >= 2**31:
        raise ValueError(f"conv3d_int8_cuda: volume too large, {tuple(xq.shape)}")
    wk = packed_weights(wq)
    out = torch.empty(shape, device=xq.device,
                      dtype=torch.int32 if out_dtype is None else out_dtype)
    with torch.cuda.device(xq.device):
        err = _library().atvsnet_conv3d_int8(
            xq.data_ptr(), wk.data_ptr(), None if scale is None else scale.data_ptr(),
            out.data_ptr(), B, D, H, W, Ci, shape[1], shape[2], shape[3], co, stride,
            pads[0][0], pads[1][0], pads[2][0], OUT_KINDS[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_int8 kernel launch failed for {tuple(xq.shape)} -> {co} "
                           f"channels at stride {stride}: cudaError {err}")
    conv3d_int8_cuda.launches += 1
    key = (B, D, H, W, Ci, co, stride)
    conv3d_int8_cuda.shape_launches[key] = conv3d_int8_cuda.shape_launches.get(key, 0) + 1
    return out


def conv3d_int8(xq: torch.Tensor, wq: torch.Tensor, stride: int, pads,
                scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if xq.device.type == "cuda":
        return conv3d_int8_cuda(xq, wq, stride, pads, scale, out_dtype)
    return conv3d_int8_torch(xq, wq, stride, pads, scale, out_dtype)


def reset_launch_counts() -> None:
    """Set the kernel's launch counts (total and per shape) to 0."""
    conv3d_int8_cuda.launches = 0
    conv3d_int8_cuda.shape_launches = {}


reset_launch_counts()
