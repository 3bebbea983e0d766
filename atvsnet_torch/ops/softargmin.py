"""Fused soft-argmin over the depth axis: a hand-written CUDA kernel and its plain versions.

    depth[b, h, w] = sum_d sweep[b, d] * softmax_d(-cost[b, d, h, w]),
    sweep[b, d] = start[b] + d * interval[b]

Replaces the Pallas TPU kernel atvsnet_tpu/ops/softargmin.py:_kernel. The CUDA source
is atvsnet_torch/csrc/softargmin.cu; it is compiled with nvcc on first use into
build/atvsnet_torch/libatvsnet_torch_kernels.so and bound with ctypes.

`softargmin_cuda` launches the kernel and accepts CUDA tensors only. The kernel has two
paths, both CUDA: "aligned" reads 16 bytes per lane and needs the volume's pointer and
its plane stride h*w*element_size to be multiples of 16 bytes; "scalar" is the same code
with one-element loads and takes everything else. `kernel_path` picks one and
`softargmin_cuda.path_launches` counts each (and `shape_launches` each volume shape). `softargmin_torch` is the plain PyTorch
version that the kernel is held against; `softargmin_split_torch` is a plain version that
mirrors the kernel's split of D into slices and chunks. `softargmin` picks by `impl`
("auto" = the kernel for CUDA tensors, `softargmin_torch` for CPU tensors). There is no
fallback from the kernel to a plain version: a CUDA tensor that the kernel cannot take
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "softargmin.cu"
BUILD_DIR = _PKG.parent / "build" / "atvsnet_torch"
LIBRARY = BUILD_DIR / "libatvsnet_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
PATHS = ("aligned", "scalar")
ALIGNMENT = 16  # bytes: the aligned path's loads and stores

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA soft-argmin kernel cannot be built")


def build(force: bool = False) -> Path:
    """Compile csrc/softargmin.cu into LIBRARY unless an up-to-date build exists."""
    global build_log
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader sees the old or the new file
    return LIBRARY


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            # pointers and the stream as c_void_p: ctypes would otherwise cut them to 32 bits
            for fn in (lib.atvsnet_softargmin_f32, lib.atvsnet_softargmin_bf16):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.atvsnet_softargmin_noop.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.atvsnet_softargmin_noop.restype = ctypes.c_int
            _lib = lib
    return _lib


def sweep(depth_num: int, depth_start: torch.Tensor, depth_interval: torch.Tensor) -> torch.Tensor:
    """(B, D) fp32 sweep values start + d * interval."""
    steps = torch.arange(depth_num, device=depth_start.device, dtype=torch.float32)
    return (depth_start.to(torch.float32)[:, None]
            + steps[None] * depth_interval.to(torch.float32)[:, None])


def softargmin_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                     depth_interval: torch.Tensor) -> torch.Tensor:
    """Plain version: cost (B, D, h, w) any float dtype -> depth (B, h, w, 1) fp32."""
    D = cost_volume.shape[1]
    p = torch.softmax(-cost_volume.to(torch.float32), dim=1)
    s = sweep(D, depth_start, depth_interval)
    return torch.sum(s[:, :, None, None] * p, dim=1)[..., None]


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    """The reference point of every exponent: the max, or 0 where nothing finite was seen."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def softargmin_split_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                           depth_interval: torch.Tensor, slices: int,
                           chunk: int = 8) -> torch.Tensor:
    """Plain version that mirrors the CUDA kernel's arithmetic: D is cut into `slices`
    contiguous slices of ceil(D / slices) planes; each slice keeps an online-softmax triple
    (max, sum, weighted sum) per pixel, updated `chunk` planes at a time; the triples are
    then combined. Planes of +inf cost contribute (max -inf, sum 0, weighted sum 0)
    wherever they fall; a pixel whose planes are all +inf is NaN, as in `softargmin_torch`.
    cost (B, D, h, w) any float dtype -> depth (B, h, w, 1) fp32."""
    if slices < 1 or chunk < 1:
        raise ValueError(f"slices and chunk must be positive, got {slices} and {chunk}")
    B, D, h, w = cost_volume.shape
    v = -cost_volume.to(torch.float32)
    s = sweep(D, depth_start, depth_interval)[:, :, None, None]
    per = -(-D // slices)
    triples = []
    for i in range(slices):
        begin, end = min(D, i * per), min(D, (i + 1) * per)
        m = v.new_full((B, h, w), -torch.inf)
        total, num = v.new_zeros((B, h, w)), v.new_zeros((B, h, w))
        for d0 in range(begin, end, chunk):
            vc, sc = v[:, d0:min(end, d0 + chunk)], s[:, d0:min(end, d0 + chunk)]
            cm = torch.maximum(m, vc.amax(dim=1))
            ref = _finite_or_zero(cm)
            r = torch.exp(m - ref)
            e = torch.exp(vc - ref[:, None])
            total, num, m = total * r + e.sum(dim=1), num * r + (sc * e).sum(dim=1), cm
        triples.append((m, total, num))
    ref = _finite_or_zero(torch.stack([m for m, _, _ in triples]).amax(dim=0))
    weights = [torch.exp(m - ref) for m, _, _ in triples]
    total = sum(t * wt for (_, t, _), wt in zip(triples, weights))
    num = sum(n * wt for (_, _, n), wt in zip(triples, weights))
    return (num / total)[..., None]


def kernel_path(data_ptr: int, plane_elements: int, dtype: torch.dtype) -> str:
    """Which path of the kernel takes a contiguous volume at `data_ptr` whose planes hold
    `plane_elements` (h*w) elements of `dtype`: "aligned" when the pointer and the plane
    stride in bytes are multiples of 16, else "scalar"."""
    stride = plane_elements * torch.empty((), dtype=dtype).element_size()
    return "aligned" if data_ptr % ALIGNMENT == 0 and stride % ALIGNMENT == 0 else "scalar"


def softargmin_cuda(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                    depth_interval: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: cost (B, D, h, w) fp32/bf16 contiguous, start/interval (B,)
    fp32 contiguous, all on one CUDA device -> depth (B, h, w, 1) fp32."""
    if cost_volume.device.type != "cuda":
        raise ValueError(f"softargmin_cuda needs CUDA tensors, got {cost_volume.device}")
    if cost_volume.dim() != 4:
        raise ValueError(f"cost volume must be (B, D, h, w), got {tuple(cost_volume.shape)}")
    B, D, h, w = cost_volume.shape
    for name, t in (("depth_start", depth_start), ("depth_interval", depth_interval)):
        if t.device != cost_volume.device or t.dtype != torch.float32 or t.shape != (B,):
            raise ValueError(f"{name} must be ({B},) float32 on {cost_volume.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not cost_volume.is_contiguous():
        raise ValueError("cost volume must be contiguous")
    fns = {torch.float32: "atvsnet_softargmin_f32", torch.bfloat16: "atvsnet_softargmin_bf16"}
    if cost_volume.dtype not in fns:
        raise ValueError(f"cost volume must be float32 or bfloat16, got {cost_volume.dtype}")
    if B * D * h * w >= 2**31 or B * D * h * w == 0:
        raise ValueError(f"unsupported cost volume shape {tuple(cost_volume.shape)}")
    fn = getattr(_library(), fns[cost_volume.dtype])
    path = kernel_path(cost_volume.data_ptr(), h * w, cost_volume.dtype)
    out = torch.empty((B, h, w, 1), device=cost_volume.device, dtype=torch.float32)
    with torch.cuda.device(cost_volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cost_volume.data_ptr(), depth_start.data_ptr(), depth_interval.data_ptr(),
                 out.data_ptr(), B, D, h * w, int(path == "aligned"), stream)
    if err != 0:
        raise RuntimeError(f"softargmin kernel launch failed on the {path} path: cudaError {err}")
    softargmin_cuda.launches += 1
    softargmin_cuda.path_launches[path] += 1
    shape = (B, D, h, w)
    softargmin_cuda.shape_launches[shape] = softargmin_cuda.shape_launches.get(shape, 0) + 1
    return out


def reset_launch_counts() -> None:
    """Set the kernel's launch counts (total, per path, per volume shape) to 0."""
    softargmin_cuda.launches = 0
    softargmin_cuda.path_launches = dict.fromkeys(PATHS, 0)
    softargmin_cuda.shape_launches = {}


reset_launch_counts()


def empty_launch(cost_volume: torch.Tensor) -> None:
    """Launch the library's no-op kernel on the grid that `softargmin_cuda` uses for this
    volume. It moves no byte and counts as no launch: its device time is what a launch of
    that grid costs."""
    B, _, h, w = cost_volume.shape
    with torch.cuda.device(cost_volume.device):
        err = _library().atvsnet_softargmin_noop(B, h * w, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty launch failed: cudaError {err}")


def softargmin(cost_volume: torch.Tensor, depth_num: int, depth_start: torch.Tensor,
               depth_interval: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """prob2depth(out_prob_map=False): cost (B, D, h, w) -> depth (B, h, w, 1) fp32."""
    if cost_volume.shape[1] != depth_num:
        raise ValueError(f"cost volume has {cost_volume.shape[1]} planes, expected {depth_num}")
    use_kernel = {"auto": cost_volume.device.type == "cuda", "cuda": True, "torch": False}[impl]
    if not use_kernel:
        return softargmin_torch(cost_volume, depth_start, depth_interval)
    return softargmin_cuda(cost_volume.contiguous(),
                           depth_start.to(torch.float32).contiguous(),
                           depth_interval.to(torch.float32).contiguous())
