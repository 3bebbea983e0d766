"""Fused soft-argmin over the depth axis: hand-written CUDA kernels and their plain versions.

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
raises. With `with_stats=True` both also return the softmax statistics, (2, B, h, w)
fp32: the max of -cost and the sum of exp(-cost - finite_or_zero(max)) per pixel.

The gradient, d cost = -g * softmax(-cost) * (sweep - depth), is one streaming kernel of
the same source (same paths) fed by those statistics. `softargmin_backward_cuda` launches
it for the whole volume with the forward's statistics, and counts its launches;
`softargmin_backward_torch` is the closed form from the depth that it is held against.
`SoftArgminFunction` ties a forward and a backward together for autograd: its forward
asks the kernel for the statistics and saves them. `softargmin` uses it on the kernel's
route whenever gradients are being recorded for the cost, and the direct launch (no
statistics) otherwise.

Over a D split across the ranks of a 'depth' mesh axis (parallel.depth.DepthSplit) each
rank holds planes [offset, offset + D_local) of the cost, and two more entry points of the
same source serve it:
  * `softargmin_partial_cuda`: the online-softmax triple of the rank's slice per pixel,
    (max of -cost, sum of exp, sum of sweep * exp) with the sweep at global plane indices;
    `merge_partials` merges the ranks' triples (plain PyTorch on (B, h, w) maps, two
    all-reduces) into the depth and the global (max, sum);
  * `softargmin_backward_stats_cuda`: the slice's gradient from the global (max, sum), the
    merged depth and the incoming gradient: the gradient kernel at the slice's offset,
    with its own counters.
`softargmin_partial_torch` and `softargmin_backward_stats_torch` are their plain versions;
the two launchers count their launches as the others do; `SplitSoftArgminFunction` ties
them together for autograd. The partial forward has its own kernel, whose grid (pixel
tiles x chunks of D, the chunks of a tile one thread-block cluster) `partial_grid` reads;
`softargmin_partial_split_torch` mirrors its order of arithmetic on that grid.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
import torch.distributed as dist

from atvsnet_torch.ops.nvcc import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_build  # noqa: F401

SOURCE = CSRC / "softargmin.cu"
LIBRARY = BUILD_DIR / "libatvsnet_torch_kernels.so"
PATHS = ("aligned", "scalar")
ALIGNMENT = 16  # bytes: the aligned path's loads and stores

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build(force: bool = False) -> Path:
    """Compile csrc/softargmin.cu into LIBRARY unless an up-to-date build exists."""
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
            for fn in (lib.atvsnet_softargmin_f32, lib.atvsnet_softargmin_bf16):
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn in (lib.atvsnet_softargmin_backward_f32, lib.atvsnet_softargmin_backward_bf16):
                fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn in (lib.atvsnet_softargmin_partial_f32, lib.atvsnet_softargmin_partial_bf16):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn in (lib.atvsnet_softargmin_grad_grid, lib.atvsnet_softargmin_partial_grid):
                fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.atvsnet_softargmin_noop.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
            for fn in (lib.atvsnet_softargmin_grad_grid, lib.atvsnet_softargmin_partial_grid,
                       lib.atvsnet_softargmin_noop):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def sweep(depth_num: int, depth_start: torch.Tensor, depth_interval: torch.Tensor,
          offset: int = 0) -> torch.Tensor:
    """(B, D) fp32 sweep values start + d * interval, d = offset .. offset + D - 1."""
    steps = torch.arange(offset, offset + depth_num, device=depth_start.device,
                         dtype=torch.float32)
    return (depth_start.to(torch.float32)[:, None]
            + steps[None] * depth_interval.to(torch.float32)[:, None])


def _compute_dtype(cost_volume: torch.Tensor) -> torch.dtype:
    """fp32 for fp32 and narrower costs (the kernels' arithmetic); fp64 stays fp64."""
    return torch.promote_types(cost_volume.dtype, torch.float32)


def softargmin_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                     depth_interval: torch.Tensor, with_stats: bool = False):
    """Plain version: cost (B, D, h, w) any float dtype -> depth (B, h, w, 1) fp32 (fp64
    for an fp64 cost); with_stats: (depth, stats), stats (2, B, h, w) the max of -cost and
    the sum of exp(-cost - finite_or_zero(max)), rows 0-1 of softargmin_partial_torch."""
    D = cost_volume.shape[1]
    p = torch.softmax(-cost_volume.to(_compute_dtype(cost_volume)), dim=1)
    s = sweep(D, depth_start, depth_interval)
    depth = torch.sum(s[:, :, None, None] * p, dim=1)[..., None]
    if not with_stats:
        return depth
    return depth, softargmin_partial_torch(cost_volume, depth_start, depth_interval)[:2]


def finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    """The reference point of every exponent: the max, or 0 where nothing finite was seen."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def _merge_triples(triples):
    """Merge (max, sum, weighted sum) triples in their order, as the kernels do: the max,
    and the two sums taken against finite_or_zero of it (a triple that saw only +inf
    weighs 0)."""
    m = torch.stack([t[0] for t in triples]).amax(dim=0)
    ref = finite_or_zero(m)
    weights = [torch.exp(t[0] - ref) for t in triples]
    total = sum(t[1] * wt for t, wt in zip(triples, weights))
    num = sum(t[2] * wt for t, wt in zip(triples, weights))
    return m, total, num


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
            ref = finite_or_zero(cm)
            r = torch.exp(m - ref)
            e = torch.exp(vc - ref[:, None])
            total, num, m = total * r + e.sum(dim=1), num * r + (sc * e).sum(dim=1), cm
        triples.append((m, total, num))
    _, total, num = _merge_triples(triples)
    return (num / total)[..., None]


def kernel_path(data_ptr: int, plane_elements: int, dtype: torch.dtype) -> str:
    """Which path of the kernel takes a contiguous volume at `data_ptr` whose planes hold
    `plane_elements` (h*w) elements of `dtype`: "aligned" when the pointer and the plane
    stride in bytes are multiples of 16, else "scalar"."""
    stride = plane_elements * torch.empty((), dtype=dtype).element_size()
    return "aligned" if data_ptr % ALIGNMENT == 0 and stride % ALIGNMENT == 0 else "scalar"


def _check_launch_inputs(name: str, cost_volume: torch.Tensor, depth_start: torch.Tensor,
                        depth_interval: torch.Tensor, maps=(), stats=None) -> None:
    """What the kernels need: cost (B, D, h, w) fp32/bf16 contiguous with fewer than 2^31
    elements, start/interval (B,) fp32, each of `maps` (B, h, w, 1) fp32 and `stats`, if
    given, (2, B, h, w) fp32, all contiguous on the cost's CUDA device."""
    if cost_volume.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {cost_volume.device}")
    if cost_volume.dim() != 4:
        raise ValueError(f"cost volume must be (B, D, h, w), got {tuple(cost_volume.shape)}")
    B, D, h, w = cost_volume.shape
    checks = [("depth_start", depth_start, (B,)), ("depth_interval", depth_interval, (B,))]
    checks += [(n, t, (B, h, w, 1)) for n, t in maps]
    if stats is not None:
        checks.append(("stats", stats, (2, B, h, w)))
    for arg, t, shape in checks:
        if t.device != cost_volume.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{arg} must be {shape} float32 on {cost_volume.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if not cost_volume.is_contiguous():
        raise ValueError("cost volume must be contiguous")
    if cost_volume.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cost volume must be float32 or bfloat16, got {cost_volume.dtype}")
    if B * D * h * w >= 2**31 or B * D * h * w == 0:
        raise ValueError(f"unsupported cost volume shape {tuple(cost_volume.shape)}")


def _count(fn, path: str, shape) -> None:
    fn.launches += 1
    fn.path_launches[path] += 1
    fn.shape_launches[shape] = fn.shape_launches.get(shape, 0) + 1


def _dtype_suffix(dtype: torch.dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


def softargmin_cuda(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                    depth_interval: torch.Tensor, with_stats: bool = False):
    """Launch the CUDA kernel: cost (B, D, h, w) fp32/bf16 contiguous, start/interval (B,)
    fp32 contiguous, all on one CUDA device -> depth (B, h, w, 1) fp32; with_stats: (depth,
    stats), the kernel also writing the (2, B, h, w) fp32 statistics of softargmin_torch."""
    _check_launch_inputs("softargmin_cuda", cost_volume, depth_start, depth_interval)
    B, D, h, w = cost_volume.shape
    fn = getattr(_library(), "atvsnet_softargmin_" + _dtype_suffix(cost_volume.dtype))
    path = kernel_path(cost_volume.data_ptr(), h * w, cost_volume.dtype)
    out = torch.empty((B, h, w, 1), device=cost_volume.device, dtype=torch.float32)
    stats = (torch.empty((2, B, h, w), device=cost_volume.device, dtype=torch.float32)
             if with_stats else None)
    with torch.cuda.device(cost_volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cost_volume.data_ptr(), depth_start.data_ptr(), depth_interval.data_ptr(),
                 out.data_ptr(), None if stats is None else stats.data_ptr(), B, D, h * w,
                 int(path == "aligned"), stream)
    if err != 0:
        raise RuntimeError(f"softargmin kernel launch failed on the {path} path: cudaError {err}")
    _count(softargmin_cuda, path, (B, D, h, w))
    return (out, stats) if with_stats else out


def softargmin_backward_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                              depth_interval: torch.Tensor, depth: torch.Tensor,
                              grad: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward, in closed form: the gradient of the loss with
    respect to the cost, -grad * softmax_d(-cost) * (sweep_d - depth), in fp32 and then in
    the cost's dtype. cost (B, D, h, w); depth, the forward's output, and grad, the loss's
    gradient with respect to it, (B, h, w, 1) -> (B, D, h, w). fp64 inputs stay fp64."""
    D, dtype = cost_volume.shape[1], _compute_dtype(cost_volume)
    p = torch.softmax(-cost_volume.to(dtype), dim=1)
    s = sweep(D, depth_start, depth_interval)[:, :, None, None]
    g, d = grad.to(dtype)[..., 0][:, None], depth.to(dtype)[..., 0][:, None]
    return (-(g * p) * (s - d)).to(cost_volume.dtype)


def _launch_gradient(counter, cost_volume, depth_start, depth_interval, offset, stats, depth,
                     grad) -> torch.Tensor:
    """Launch the gradient kernel on planes offset .. offset + D - 1 of the sweep and count
    the launch on `counter` (one of the two entry points): the gradient with respect to
    the cost, (B, D, h, w) in the cost's dtype, a fresh aligned allocation. The path
    follows the forward's rule (`kernel_path`)."""
    name = counter.__name__
    _check_launch_inputs(name, cost_volume, depth_start, depth_interval,
                         maps=(("depth", depth), ("grad", grad)), stats=stats)
    B, D, h, w = cost_volume.shape
    fn = getattr(_library(), "atvsnet_softargmin_backward_" + _dtype_suffix(cost_volume.dtype))
    path = kernel_path(cost_volume.data_ptr(), h * w, cost_volume.dtype)
    # the aligned path reads the maps 16 bytes at a time: a map that starts elsewhere (a
    # view into a larger buffer) is copied, which costs a few bytes per pixel
    stats, depth, grad = (t if t.data_ptr() % ALIGNMENT == 0 else t.clone()
                          for t in (stats, depth, grad))
    out = torch.empty_like(cost_volume)
    with torch.cuda.device(cost_volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cost_volume.data_ptr(), depth_start.data_ptr(), depth_interval.data_ptr(),
                 stats.data_ptr(), depth.data_ptr(), grad.data_ptr(), out.data_ptr(), B, D,
                 h * w, int(offset), int(path == "aligned"), stream)
    if err != 0:
        raise RuntimeError(f"{name}: gradient kernel launch failed on the {path} path: "
                           f"cudaError {err}")
    _count(counter, path, (B, D, h, w))
    return out


def softargmin_backward_cuda(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                             depth_interval: torch.Tensor, stats: torch.Tensor,
                             depth: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Launch the gradient kernel on the whole volume: the inputs of `softargmin_cuda`, the
    statistics (2, B, h, w) that it returned with the depth, the depth and the incoming
    gradient (B, h, w, 1), all fp32 contiguous -> the gradient with respect to the cost,
    (B, D, h, w) in the cost's dtype (softargmin_backward_torch's closed form)."""
    return _launch_gradient(softargmin_backward_cuda, cost_volume, depth_start,
                            depth_interval, 0, stats, depth, grad)


def packet_pixels(dtype: torch.dtype, path: str) -> int:
    """Pixels a lane loads from one plane: 16 bytes of `dtype` on the aligned path (4 fp32,
    8 bf16), one on the scalar path."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    return ALIGNMENT // torch.empty((), dtype=dtype).element_size() if path == "aligned" else 1


def _query_grid(name: str, what: str, n: int, shape, dtype, path, device) -> tuple:
    B, D, h, w = shape
    grid = (ctypes.c_int * n)()
    with torch.cuda.device(device):
        err = getattr(_library(), name)(B, D, h * w, packet_pixels(dtype, path), grid)
    if err != 0:
        raise RuntimeError(f"reading the {what} grid failed: cudaError {err}")
    return tuple(grid)


def gradient_grid(shape, dtype: torch.dtype, path: str, device=None) -> tuple[int, int, int]:
    """The gradient kernel's grid for a (B, D, h, w) volume of `dtype` on `path` on the
    current (or given) CUDA device: (pixel tiles, chunks of D, planes per chunk)."""
    return _query_grid("atvsnet_softargmin_grad_grid", "gradient kernel's", 3, shape, dtype,
                       path, device)


def partial_grid(shape, dtype: torch.dtype, path: str, device=None) -> tuple[int, ...]:
    """The partial kernel's grid for a (B, D_local, h, w) slice of `dtype` on `path` on the
    current (or given) CUDA device: (pixel tiles, chunks of D, cluster size, warps per
    block, planes a thread folds at a time); the chunks of a tile form one cluster (none
    with one chunk), chunk c holding D // chunks planes, one more for c < D % chunks. The
    last three are the arguments of softargmin_partial_split_torch that mirror the kernel."""
    return _query_grid("atvsnet_softargmin_partial_grid", "partial kernel's", 5, shape, dtype,
                       path, device)


# ---- the soft-argmin over a D split across ranks ----

def softargmin_partial_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                             depth_interval: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Plain version of the partial forward: cost (B, D_local, h, w), planes offset ..
    offset + D_local - 1 of the sweep -> (3, B, h, w) fp32: the max of -cost, and the sums
    of exp(-cost - ref) and of sweep * exp(-cost - ref), ref = the max, or 0 where every
    plane is +inf (then the triple is (-inf, 0, 0))."""
    v = -cost_volume.to(_compute_dtype(cost_volume))
    m = v.amax(dim=1)
    e = torch.exp(v - finite_or_zero(m)[:, None])
    s = sweep(v.shape[1], depth_start, depth_interval, offset)[:, :, None, None]
    return torch.stack([m, e.sum(dim=1), (s * e).sum(dim=1)])


def softargmin_partial_split_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                                   depth_interval: torch.Tensor, offset: int = 0,
                                   chunks: int = 1, warps: int = 4,
                                   batch: int = 4) -> torch.Tensor:
    """Plain version that mirrors softargmin_partial_kernel's order of arithmetic (the grid
    of `partial_grid`): D_local is cut into `chunks` runs of D // chunks planes, the first
    D % chunks of them one plane longer; in each chunk warp k folds planes k, k + warps, ...
    into an online-softmax triple `batch` planes at a time; the warps' triples are merged,
    then, with more than one chunk, the chunks' (the cluster's merge). The inputs of
    softargmin_partial_torch -> the same (3, B, h, w) fp32 triple. Used by tests only."""
    if min(chunks, warps, batch) < 1:
        raise ValueError("chunks, warps and batch must be positive, "
                         f"got {chunks}, {warps}, {batch}")
    B, D, h, w = cost_volume.shape
    v = -cost_volume.to(torch.float32)
    s = sweep(D, depth_start, depth_interval, offset)[:, :, None, None]
    per, rem = divmod(D, chunks)
    per_chunk = []
    for c in range(chunks):
        first = c * per + min(c, rem)
        per_warp = []
        for k in range(warps):
            planes = list(range(first + k, first + per + (c < rem), warps))
            m = v.new_full((B, h, w), -torch.inf)
            total, num = v.new_zeros((B, h, w)), v.new_zeros((B, h, w))
            for i in range(0, len(planes), batch):
                vc, sc = v[:, planes[i:i + batch]], s[:, planes[i:i + batch]]
                cm = torch.maximum(m, vc.amax(dim=1))
                ref = finite_or_zero(cm)
                r = torch.exp(m - ref)
                e = torch.exp(vc - ref[:, None])
                total, num, m = total * r + e.sum(dim=1), num * r + (sc * e).sum(dim=1), cm
            per_warp.append((m, total, num))
        per_chunk.append(_merge_triples(per_warp))
    return torch.stack(_merge_triples(per_chunk) if chunks > 1 else per_chunk[0])


def merge_partials(triple: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge the ranks' partial triples (3, B, h, w) over `group` (None: one rank):
    (depth (B, h, w, 1), stats (2, B, h, w): the global max and the global sum taken
    against finite_or_zero of it). A pixel whose planes are all +inf on every rank is
    NaN, as in softargmin_torch. Two all-reduces, no gradient: SplitSoftArgminFunction
    differentiates it."""
    m = triple[0].clone()
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    sums = triple[1:] * torch.exp(triple[0] - finite_or_zero(m))
    if group is not None:
        dist.all_reduce(sums, group=group)
    return (sums[1] / sums[0])[..., None], torch.stack([m, sums[0]])


def softargmin_backward_stats_torch(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                                    depth_interval: torch.Tensor, offset: int,
                                    stats: torch.Tensor, depth: torch.Tensor,
                                    grad: torch.Tensor) -> torch.Tensor:
    """Plain version of the stats-fed backward: -grad * p_d * (sweep_d - depth) on the
    slice, p_d = exp(-cost_d - ref) / sum with (max, sum) = stats (2, B, h, w) the merged
    ones (ref = finite_or_zero(max)); depth and grad (B, h, w, 1) -> (B, D_local, h, w) in
    the cost's dtype."""
    dtype = _compute_dtype(cost_volume)
    ref, total = finite_or_zero(stats[0]).to(dtype), stats[1].to(dtype)
    p = torch.exp(-cost_volume.to(dtype) - ref[:, None]) / total[:, None]
    s = sweep(cost_volume.shape[1], depth_start, depth_interval, offset)[:, :, None, None]
    g, d = grad.to(dtype)[..., 0][:, None], depth.to(dtype)[..., 0][:, None]
    return (-(g * p) * (s - d)).to(cost_volume.dtype)


def softargmin_partial_cuda(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                            depth_interval: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Launch the partial forward kernel: the inputs of `softargmin_cuda` and the slice's
    first global plane -> (3, B, h, w) fp32, as softargmin_partial_torch. Paths as the
    forward's (`kernel_path`)."""
    _check_launch_inputs("softargmin_partial_cuda", cost_volume, depth_start, depth_interval)
    B, D, h, w = cost_volume.shape
    fn = getattr(_library(), "atvsnet_softargmin_partial_" + _dtype_suffix(cost_volume.dtype))
    path = kernel_path(cost_volume.data_ptr(), h * w, cost_volume.dtype)
    out = torch.empty((3, B, h, w), device=cost_volume.device, dtype=torch.float32)
    with torch.cuda.device(cost_volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cost_volume.data_ptr(), depth_start.data_ptr(), depth_interval.data_ptr(),
                 out.data_ptr(), B, D, h * w, int(offset), int(path == "aligned"), stream)
    if err != 0:
        raise RuntimeError(f"softargmin partial kernel launch failed on the {path} path: "
                           f"cudaError {err}")
    _count(softargmin_partial_cuda, path, (B, D, h, w))
    return out


def softargmin_backward_stats_cuda(cost_volume: torch.Tensor, depth_start: torch.Tensor,
                                   depth_interval: torch.Tensor, offset: int,
                                   stats: torch.Tensor, depth: torch.Tensor,
                                   grad: torch.Tensor) -> torch.Tensor:
    """Launch the gradient kernel on a D split's slice: the inputs of
    softargmin_backward_stats_torch, stats (2, B, h, w) the merged ones, depth and grad
    (B, h, w, 1), all fp32 contiguous -> the slice's gradient (B, D_local, h, w) in the
    cost's dtype."""
    return _launch_gradient(softargmin_backward_stats_cuda, cost_volume, depth_start,
                            depth_interval, offset, stats, depth, grad)


def reset_launch_counts() -> None:
    """Set every kernel's launch counts (total, per path, per volume shape) to 0."""
    for fn in (softargmin_cuda, softargmin_backward_cuda, softargmin_partial_cuda,
               softargmin_backward_stats_cuda):
        fn.launches = 0
        fn.path_launches = dict.fromkeys(PATHS, 0)
        fn.shape_launches = {}


reset_launch_counts()


EMPTY_LAUNCH_GRIDS = ("forward", "gradient", "partial")


def empty_launch(cost_volume: torch.Tensor, grid: str = "forward") -> None:
    """Launch the library's no-op kernel on the grid that `softargmin_cuda` ("forward"),
    the gradient kernel ("gradient") or the partial kernel ("partial", launched as that
    kernel is: the same clusters, a programmatic dependent launch) uses for this volume.
    It moves no byte and counts as no launch: its device time is what a launch of that
    grid costs."""
    B, D, h, w = cost_volume.shape
    path = kernel_path(cost_volume.data_ptr(), h * w, cost_volume.dtype)
    with torch.cuda.device(cost_volume.device):
        err = _library().atvsnet_softargmin_noop(B, D, h * w,
                                                 packet_pixels(cost_volume.dtype, path),
                                                 EMPTY_LAUNCH_GRIDS.index(grid),
                                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty launch failed: cudaError {err}")


class SoftArgminFunction(torch.autograd.Function):
    """Soft-argmin with its closed-form backward, for autograd: the counterpart of the JAX
    package's custom_vjp `softargmin_fused`.

    `apply(cost, depth_start, depth_interval)`: cost (B, D, h, w) fp32/bf16, start and
    interval (B,) fp32, all CUDA tensors -> depth (B, h, w, 1) fp32. It launches the two
    kernels (`softargmin_cuda` with the statistics, then `softargmin_backward_cuda` on the
    saved cost, statistics and depth: under torch.utils.checkpoint the recomputed forward
    writes them again) and raises ValueError for a tensor that is not on the card, as they do; the
    plain route's gradient is autograd of `softargmin_torch`. The gradient reaches the
    cost only. The sweep comes from the cameras, which training never differentiates
    (neither does the JAX package): the backward returns None for start and interval, and
    a call in which either of them requires grad raises ValueError.
    """

    @staticmethod
    def forward(ctx, cost_volume, depth_start, depth_interval):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError("the soft-argmin's gradient reaches the cost only: depth_start "
                             "and depth_interval must not require grad")
        depth, stats = softargmin_cuda(cost_volume, depth_start, depth_interval, with_stats=True)
        ctx.save_for_backward(cost_volume, depth_start, depth_interval, stats, depth)
        return depth

    @staticmethod
    def backward(ctx, grad):
        cost_volume, depth_start, depth_interval, stats, depth = ctx.saved_tensors
        grad = grad.to(depth.dtype).contiguous()
        return (softargmin_backward_cuda(cost_volume, depth_start, depth_interval, stats, depth,
                                         grad), None, None)


class SplitSoftArgminFunction(torch.autograd.Function):
    """Soft-argmin over a D split across a depth group, for autograd.

    `apply(cost, depth_start, depth_interval, split, use_kernel)`: cost (B, D_local, h, w),
    this rank's planes split.planes of split.depth_num -> the merged depth (B, h, w, 1)
    fp32, the same on every rank. The forward is the partial forward (kernel, or its plain
    version when use_kernel is False) and merge_partials. Every rank of the group
    differentiates its copy of the depth, so the backward first sums the incoming
    gradient over the group (the adjoint of handing every rank the merged value, as
    torch.distributed.nn's all-reduce takes it), then writes the slice's gradient with the
    stats-fed backward. As SoftArgminFunction, the gradient reaches the cost only.
    """

    @staticmethod
    def forward(ctx, cost_volume, depth_start, depth_interval, split, use_kernel):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError("the soft-argmin's gradient reaches the cost only: depth_start "
                             "and depth_interval must not require grad")
        partial = softargmin_partial_cuda if use_kernel else softargmin_partial_torch
        depth, stats = merge_partials(partial(cost_volume, depth_start, depth_interval,
                                              split.offset), split.group)
        ctx.save_for_backward(cost_volume, depth_start, depth_interval, stats, depth)
        ctx.split, ctx.use_kernel = split, use_kernel
        return depth

    @staticmethod
    def backward(ctx, grad):
        cost_volume, depth_start, depth_interval, stats, depth = ctx.saved_tensors
        grad = grad.to(torch.float32).contiguous().clone()
        if ctx.split.group is not None:
            dist.all_reduce(grad, group=ctx.split.group)
        fn = softargmin_backward_stats_cuda if ctx.use_kernel else softargmin_backward_stats_torch
        return (fn(cost_volume, depth_start, depth_interval, ctx.split.offset, stats, depth, grad),
                None, None, None, None)


def softargmin(cost_volume: torch.Tensor, depth_num: int, depth_start: torch.Tensor,
               depth_interval: torch.Tensor, impl: str = "auto", split=None) -> torch.Tensor:
    """prob2depth(out_prob_map=False): cost (B, D, h, w) -> depth (B, h, w, 1) fp32.

    On the kernel's route ("cuda", or "auto" with a CUDA tensor) a cost that gradients are
    recorded for goes through SoftArgminFunction (forward and backward kernels); otherwise
    the forward kernel is launched directly. The plain route is softargmin_torch, whose
    gradient autograd derives. With a depth `split` (parallel.depth.DepthSplit) the cost
    holds this rank's planes and SplitSoftArgminFunction runs, on the kernels or, on the
    plain route, on their plain versions."""
    planes = cost_volume.shape[1] * (1 if split is None else split.size)
    if planes != depth_num:
        raise ValueError(f"cost volume has {planes} planes, expected {depth_num}")
    use_kernel = {"auto": cost_volume.device.type == "cuda", "cuda": True, "torch": False}[impl]
    if split is None and not use_kernel:
        return softargmin_torch(cost_volume, depth_start, depth_interval)
    args = (cost_volume.contiguous(), depth_start.to(torch.float32).contiguous(),
            depth_interval.to(torch.float32).contiguous())
    if split is not None:
        return SplitSoftArgminFunction.apply(*args, split, use_kernel)
    if torch.is_grad_enabled() and cost_volume.requires_grad:
        return SoftArgminFunction.apply(*args)
    return softargmin_cuda(*args)
