"""fp32 transposed 3D convolution, fp32_precision="highest": a hand-written CUDA kernel on
Hopper's CUDA cores (a parity decomposition in FFMA that writes the cropped output), its
autograd Function and its plain version.

    full[b, o, co] = sum over (i, k) with o = 2 i + k per axis, and ci, of
                     x[b, i, ci] * w[ci, co, k]          (conv_transpose3d, stride 2, padding 0)
    out[b, o, co]  = full[b, o + beg, co],  o in [0, 2 n - beg) per axis

x is float32 (B, D, H, W, Ci), channel-last as every volume of the port; w is PyTorch's
transpose layout (Ci, Co, 3, 3, 3); `begs` gives the crop begin of D, H and W (even: 0 in a
forward, whose TF-SAME crop on an even size is (0, 1); 2 on D for a depth split's block,
which starts with its left neighbour's last plane). The output is channel-last
(B, 2D - bd, 2H - bh, 2W - bw, Co), contiguous.

This is the route of every float32 3x3x3 stride-2 transposed conv in "highest"
(nn.layers.deconv): the three of each CRM U-Net pass and the refinement's three. The JAX
package leaves them to XLA; the kernel replaces cuDNN's convolveNd_dgrad_float_engine with
TF32 off and the setTensor5d fill of its uncropped output. The CUDA source is
atvsnet_torch/csrc/conv3d_transpose_fp32.cu (its note gives the design and the bound),
compiled with nvcc on first use into
build/atvsnet_torch/libatvsnet_torch_conv3d_transpose_fp32.so and bound with ctypes.

  * `plan` picks the path ("vector": 16-byte copies of 4 channels, which need Ci % 4 == 0
    and a 16-byte aligned x; "scalar": 4-byte copies) and the tiling (the output channels a
    thread holds, `tn`; its cells along D, `planes`; the channel groups of a block, which
    share its input brick, `groups`; the stages of the copy ring) from (Ci, Co) alone;
  * `conv3d_transpose_fp32_cuda` launches on CUDA tensors only, counts its launches (in
    total, per path in `path_launches`, and per (x shape, w shape, begs) in
    `shape_launches`) and raises on anything it does not take;
  * `ConvTranspose3dFp32Function` is its autograd Function: the backward is aten's
    convolution_backward of the transposed conv with TF32 off, on the cotangent zero-padded
    back to the uncropped shape, as autograd ran it through the crop's slice before, so
    training's gradients are what they were; `conv3d_transpose_fp32_torch` is the plain
    version (pass_conv_transpose in "highest", then the crop: the route's call before the
    kernel), and `conv3d_transpose_fp32` picks by device: the Function for CUDA tensors, the
    plain version for CPU tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from atvsnet_torch.ops.fp32_passes import ConvSpec, pass_conv_transpose, tf32
from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, CudaLibrary, count_launch, launch_counts

SOURCE = CSRC / "conv3d_transpose_fp32.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_conv3d_transpose_fp32.so"
PATHS = ("vector", "scalar")   # the C side's path index
THREADS = 128                  # a block's threads: channel groups x input cells along (w, h)
KERNEL = (3, 3, 3)             # the only kernel size it takes, at stride 2
STRIDE = 2

LIB = CudaLibrary(SOURCE, LIBRARY, {
    "atvsnet_conv3d_transpose_fp32": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
                                      + [ctypes.c_void_p], ctypes.c_int)})
build = LIB.build
__getattr__ = LIB.module_getattr(__name__)   # build_log


def takes(w_shape: Sequence[int], stride: int) -> bool:
    """Whether the kernel computes a transposed conv of this kernel shape and stride."""
    return len(w_shape) == 5 and tuple(w_shape[2:]) == KERNEL and stride == STRIDE


def output_shape(x_shape: Sequence[int], w_shape: Sequence[int],
                 begs: Sequence[int]) -> tuple[int, int, int, int, int]:
    """(B, 2D - bd, 2H - bh, 2W - bw, Co) of a (B, D, H, W, Ci) input, w (Ci, Co, 3, 3, 3)."""
    return (x_shape[0],) + tuple(2 * n - b for n, b in zip(x_shape[1:4], begs)) + (w_shape[1],)


def block_cells(groups: int) -> tuple[int, int]:
    """(CW, CH): the input cells along w and h of a block of `groups` channel groups, the
    wider side first (the C side's TileT)."""
    cells = THREADS // groups
    cw = 1 << (((cells - 1).bit_length() + 1) // 2)
    return cw, cells // cw


def plan(ci: int, co: int, aligned: bool = True) -> dict:
    """The launch's plan from (Ci, Co) alone: the path ("vector" where Ci % 4 == 0 and x is
    16-byte aligned, else "scalar"); `tn` output channels a thread, `planes` cells along D a
    thread, `groups` channel groups a block (a block covers groups * tn output channels and
    shares its input brick between them), `stages` of the copy ring. One tiling serves every
    class: on an H100 it was the fastest of those tried at each (csrc note)."""
    return {"path": "vector" if ci % 4 == 0 and aligned else "scalar", "tn": 2, "planes": 4,
            "groups": 4, "stages": 2}


def conv3d_transpose_fp32_torch(x: torch.Tensor, w: torch.Tensor,
                                begs: Sequence[int]) -> torch.Tensor:
    """Plain version on any device: pass_conv_transpose in "highest" (aten's transposed
    conv, TF32 off) on the channel-first view, then the crop: the route's call before the
    kernel."""
    y = pass_conv_transpose(x.movedim(-1, 1), w, "highest", STRIDE)
    crop = tuple(slice(b, 2 * n) for n, b in zip(x.shape[1:4], begs))
    return y[(slice(None), slice(None)) + crop].movedim(1, -1)


def _check(x: torch.Tensor, w: torch.Tensor, begs) -> None:
    """Raise unless the kernel takes these operands: float32 tensors, x (B, D, H, W, Ci),
    w (Ci, Co, 3, 3, 3), three even crop begins >= 0, an output, sizes that int32 indexes,
    and CUDA tensors on one device."""
    name = "conv3d_transpose_fp32_cuda"
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 tensors, got {x.dtype}, {w.dtype}")
    if x.dim() != 5 or not takes(w.shape, STRIDE) or w.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: x must be (B, D, H, W, Ci) and w (Ci, Co, 3, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if len(begs) != 3 or any(b < 0 or b % 2 for b in begs):
        raise ValueError(f"{name}: crop begins {tuple(begs)} must be three even numbers >= 0")
    shape = output_shape(x.shape, w.shape, begs)
    if min(shape) < 1:
        raise ValueError(f"{name}: no output for {tuple(x.shape)} cropped from {tuple(begs)}")
    if x.numel() >= 2**31 or torch.Size(shape).numel() >= 2**31:
        raise ValueError(f"{name}: tensor too large, {tuple(x.shape)} -> {shape}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got {x.device}, {w.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, begs, p: dict) -> torch.Tensor:
    """One launch with plan p on contiguous operands; returns the output."""
    B, D, H, W, ci = x.shape
    out = torch.empty(output_shape(x.shape, w.shape, begs), device=x.device,
                      dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = LIB().atvsnet_conv3d_transpose_fp32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, D, H, W, ci, w.shape[1], *begs,
            PATHS.index(p["path"]), p["tn"], p["planes"], p["groups"], p["stages"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_transpose_fp32 kernel launch failed for {tuple(x.shape)} "
                           f"with {tuple(w.shape)}, crop begins {tuple(begs)} ({p}): "
                           f"cudaError {err}")
    return out


def conv3d_transpose_fp32_cuda(x: torch.Tensor, w: torch.Tensor,
                               begs: Sequence[int]) -> torch.Tensor:
    """Launch the CUDA kernel: x (B, D, H, W, Ci) and w (Ci, Co, 3, 3, 3), float32 CUDA
    tensors on one device -> (B, 2D - bd, 2H - bh, 2W - bw, Co), channel-last."""
    begs = tuple(begs)
    _check(x, w, begs)
    x = x.contiguous()
    p = plan(x.shape[-1], w.shape[1], aligned=x.data_ptr() % 16 == 0)
    out = _launch(x, w.contiguous(), begs, p)
    count_launch(conv3d_transpose_fp32_cuda, p["path"], (tuple(x.shape), tuple(w.shape), begs))
    return out


class ConvTranspose3dFp32Function(torch.autograd.Function):
    """The kernel's forward; the backward is pass_conv_transpose's "highest" backward (aten's
    convolution_backward with TF32 off) on the cotangent zero-padded to the uncropped
    output, the crop's slice backward: training's gradients are what they were before the
    kernel."""

    @staticmethod
    def forward(ctx, x, w, begs):
        ctx.save_for_backward(x, w)
        ctx.begs = begs
        return conv3d_transpose_fp32_cuda(x, w, begs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        xc = x.movedim(-1, 1)
        full = g.new_zeros((g.shape[0], g.shape[-1]) + tuple(2 * n + 1 for n in x.shape[1:4]))
        crop = tuple(slice(b, b + n) for b, n in zip(ctx.begs, g.shape[1:4]))
        full[(slice(None), slice(None)) + crop] = g.movedim(-1, 1)
        spec = ConvSpec.of(3, STRIDE, transposed=True)
        with tf32(False):
            gx, gw, _ = spec.backward(xc, full, w, [need_x, need_w, False])
        return None if gx is None else gx.movedim(1, -1), gw, None


def conv3d_transpose_fp32(x: torch.Tensor, w: torch.Tensor,
                          begs: Sequence[int]) -> torch.Tensor:
    """The kernel (under autograd) for CUDA tensors, the plain version for CPU tensors."""
    begs = tuple(int(b) for b in begs)
    if x.device.type == "cuda":
        return ConvTranspose3dFp32Function.apply(x, w, begs)
    return conv3d_transpose_fp32_torch(x, w, begs)


reset_launch_counts = launch_counts(PATHS, conv3d_transpose_fp32_cuda)
