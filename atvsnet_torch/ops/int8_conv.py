"""int8 3D convolution with int32 accumulation: a hand-written CUDA kernel on Hopper's
tensor cores, its launch planner, and its plain version.

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
bound with ctypes. It has three paths (the source's note says why each exists):
"ring" (input planes streamed along D by TMA loads into a ring in shared memory),
"ring_cluster" (the same, the 27 taps split by kd across a cluster of 3 blocks) and
"generic" (a patch staged per tile, for inputs that no tensor map describes).

  * `plan` computes a launch plan from the shapes and two numbers of the card (its SM
    count and opt-in shared memory per block; an H100's by default): the path, the tile,
    the ring's depth, the D chunks, the cluster and the grid. The C side checks the plan
    and refuses what it cannot take; it never plans itself.
  * `conv3d_int8_cuda` plans and launches on CUDA tensors only, counts its launches (in
    total, per path in `path_launches`, and per (B, D, H, W, Ci, Co, stride) in
    `shape_launches`) and raises on anything it does not take: Co above 64, an input with
    no plan that fits, a plan the C side refuses.
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

# ---- the launch plan (mirrors csrc/int8_conv.cu: its layout constants and PlanField) ----
PATHS = ("generic", "ring", "ring_cluster")
PLAN_FIELDS = ("path", "tile_w", "tile_h", "ring", "planes", "chunks", "cluster", "grid",
               "blocks_per_sm", "smem_bytes")
H100_SMS = 132
H100_SMEM_OPTIN = 232_448          # bytes of shared memory a block may opt in to
SMEM_RESERVED = 1_024              # bytes the card reserves per resident block
TILE_M = 128                       # output voxels per tile (16 rows of M per warp)
TILE_WIDTHS = (128, 64, 32, 16, 8)
WEIGHT_ROW_PAD = 16               # generic: bytes after each weight row in shared memory
MAX_RING = 8
LEAST_RING = {1: 4, 2: 5}          # the window's 3 planes and the next plane's loads in flight
CLUSTER = 3                        # ring_cluster: one block per kd
RECV_BYTES_PER_NF = 2 * 3 * 32 * 16   # a rank's receive buffer per N fragment
BOX_MAX = 256                      # a tensor map's box extent, elements per dimension
ITEM_START = 2                     # an item's start, in output planes' time (chunk choice)
# ring_cluster where the ring plan has fewer output plane-tiles than this per SM: see plan()
CLUSTER_PLANE_TILES_PER_SM = 1

_lib = None
_lib_lock = threading.Lock()
_device_limits: dict = {}
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
                                                + [ctypes.c_void_p] * 2)
            lib.atvsnet_conv3d_int8_check.argtypes = [ctypes.c_int] * 14 + [ctypes.c_void_p] * 2
            lib.atvsnet_conv3d_int8_noop.argtypes = [ctypes.c_int] * 14 + [ctypes.c_void_p] * 2
            lib.atvsnet_conv3d_int8_device.argtypes = [ctypes.c_void_p]
            for fn in (lib.atvsnet_conv3d_int8, lib.atvsnet_conv3d_int8_check,
                       lib.atvsnet_conv3d_int8_noop, lib.atvsnet_conv3d_int8_device):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def output_shape(x_shape: Sequence[int], co: int, stride: int, pads) -> tuple[int, ...]:
    """(B, Do, Ho, Wo, Co) of a 3x3x3 conv of a (B, D, H, W, Ci) input at `stride` with
    `pads` ((lo, hi) per D, H, W)."""
    B, *spatial, _ = x_shape
    return (B, *((n + lo + hi - 3) // stride + 1 for n, (lo, hi) in zip(spatial, pads)), co)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def fragments(co: int) -> int:
    """N fragments of 8 channels the kernel instantiation for Co holds (1, 2, 4 or 8)."""
    nf = -(-co // 8)
    return next(k for k in (1, 2, 4, 8) if k >= nf)


def min_blocks_per_sm(co: int, ci: int = 0, split: int = 0) -> int:
    """The kernels' __launch_bounds__ minimum of resident blocks per SM for Co: 4 up to 2
    fragments, else 2; one ring block (split 1) that holds its K in registers takes 3 at
    Ci 8 and 2 fragments, 2 at Ci 16."""
    nf = fragments(co)
    if split == 1 and ci in (8, 16) and nf <= 2:
        return 2 if ci == 16 else 3 if nf == 2 else 4
    return 4 if nf <= 2 else 2


def planes_per_pass(co: int, split: int) -> int:
    """Output planes a pass of a ring kernel computes: two on one block at 4 or more
    fragments, else one."""
    return 2 if split == 1 and fragments(co) >= 4 else 1


def map_layout(x_shape: Sequence[int], aligned: bool = True) -> Optional[str]:
    """The tensor map that describes a (B, D, H, W, Ci) int8 input: "merged" (W*Ci, H, D, B)
    at Ci 8 with W*Ci a multiple of 16 bytes, "5d" (Ci, W, H, D, B) at Ci a multiple of 16,
    else None (also for a base that is not 16-byte aligned)."""
    w, ci = x_shape[-2], x_shape[-1]
    if not aligned:
        return None
    if ci == 8 and w * ci % 16 == 0:
        return "merged"
    return "5d" if ci % 16 == 0 else None


def packed_weights(wq: torch.Tensor) -> torch.Tensor:
    """The generic kernel's weight matrix: (round_up(Co, 8), K) int8 with K = round_up(27 *
    Ci4, 32), Ci4 = round_up(Ci, 4), and column k = tap * Ci4 + ci for tap = kd * 9 + kh * 3
    + kw; zero past Co, Ci and the 27 taps. A ring kernel gathers the same rows from wq into
    its shared memory (a cluster's rank kd the 9 taps of its kd, columns from 9 * kd * Ci)."""
    co, ci = wq.shape[:2]
    ci4 = _round_up(ci, 4)
    k = 27 * ci4
    taps = F.pad(wq.permute(0, 2, 3, 4, 1), (0, ci4 - ci)).reshape(co, k)
    return F.pad(taps, (0, _round_up(k, 32) - k, 0, _round_up(co, 8) - co)).contiguous()


def ring_wstride(kc: int) -> int:
    """Bytes of a weight row in the ring kernels' shared memory: kc padded to 32 mod 128, so
    that a half-warp's 8-byte B loads fall in distinct banks."""
    return kc + (32 - kc) % 128


def _blocks_per_sm(smem: int, least: int, smem_optin: int) -> int:
    """Blocks of `smem` bytes an SM holds at once, at most the launch bounds' `least`."""
    return min(least, (smem_optin + SMEM_RESERVED) // (smem + SMEM_RESERVED))


def _generic_plan(x_shape, co: int, stride: int, out: tuple, sms: int, smem_optin: int):
    """The generic tile (tile_w from 128 down to 16, the one that stages the fewest input voxels
    over the plane among those that fit) and a grid of at most the resident blocks."""
    B, _, _, _, ci = x_shape
    _, Do, Ho, Wo, _ = out
    ci4, np_ = _round_up(ci, 4), _round_up(co, 8)
    kp = _round_up(27 * ci4, 32)
    best = None
    for tw in (128, 64, 32, 16):
        th = TILE_M // tw
        in_w, in_h = (tw - 1) * stride + 3, (th - 1) * stride + 3
        tiles = -(-Wo // tw) * -(-Ho // th)
        smem = np_ * (kp + WEIGHT_ROW_PAD) + kp + 3 * in_h * in_w * ci4
        if smem <= smem_optin and (best is None or tiles * in_w * in_h < best[0]):
            best = (tiles * in_w * in_h, tw, th, smem, tiles)
    if best is None:
        return None
    _, tw, th, smem, tiles = best
    bps = _blocks_per_sm(smem, min_blocks_per_sm(co), smem_optin)
    return dict(path="generic", tile_w=tw, tile_h=th, ring=0, planes=0, chunks=0, cluster=1,
                grid=min(B * Do * tiles, sms * bps), blocks_per_sm=bps, smem_bytes=smem,
                map=None, items=B * Do * tiles, staged_bytes=B * Do * best[0] * 3 * ci4)


def _chunks(Do: int, units: int, slots: int) -> tuple[int, int, int]:
    """Output planes per D chunk, chunks and rounds of the resident `slots` for `units`
    columns: the chunking whose busiest slot has the least work, an item counted as its
    planes plus ITEM_START; on a tie the fewest chunks."""
    best = None
    for c in range(1, Do + 1):
        planes = -(-Do // c)
        chunks = -(-Do // planes)
        items = units * chunks
        rounds = -(-items // min(items, slots))
        cost = rounds * (planes + ITEM_START)
        if best is None or cost < best[0]:
            best = (cost, planes, chunks, rounds)
    return best[1:]


def _ring_plan(x_shape, co: int, stride: int, pw: int, out: tuple, split: int, layout: str,
               sms: int, smem_optin: int):
    """The ring (split 1) or ring_cluster (split 3) plan: the tile that stages the fewest
    bytes per input plane among those whose box the map takes, the deepest ring (up to
    MAX_RING) that leaves the launch bounds' blocks per SM, and the D chunks. A merged box
    starts on a 16-byte boundary, `shift` = (-pw * Ci) mod 16 bytes before the window."""
    B, _, _, _, ci = x_shape
    shift = -pw * ci % 16 if layout == "merged" else 0
    _, Do, Ho, Wo, _ = out
    np_ = _round_up(co, 8)
    kc = _round_up((27 if split == 1 else 9) * ci, 32)
    fixed = (np_ * ring_wstride(kc) + kc // 2 + 128
             + (RECV_BYTES_PER_NF * fragments(co) + 8 if split > 1 else 0))
    least = 2 if split > 1 else LEAST_RING[stride]
    tiles = []
    for tw in TILE_WIDTHS:
        th = TILE_M // tw
        in_w, in_h = (tw - 1) * stride + 3, (th - 1) * stride + 3
        pitch = _round_up(in_w * ci + shift, 16) if layout == "merged" else in_w * ci
        if (pitch if layout == "merged" else ci) > BOX_MAX or max(in_w, in_h) > BOX_MAX:
            continue
        n = -(-Wo // tw) * -(-Ho // th)
        tiles.append((n * pitch * in_h, -tw, th, in_w, in_h, pitch, n))
    for staged, neg_tw, th, in_w, in_h, pitch, n in sorted(tiles):
        stage = _round_up(pitch * in_h, 128)
        for bps in range(min_blocks_per_sm(co, ci, split), 0, -1):
            budget = (smem_optin + SMEM_RESERVED) // bps - SMEM_RESERVED
            ring = min(MAX_RING, (budget - fixed) // (stage + 8))
            if ring >= least:
                break
        else:
            continue
        smem = fixed + ring * (stage + 8)
        bps = _blocks_per_sm(smem, min_blocks_per_sm(co, ci, split), smem_optin)
        slots = max(1, sms * bps // split)
        planes, chunks, rounds = _chunks(Do, B * n, slots)
        items = B * n * chunks
        box = [pitch, in_h, 1, 1] if layout == "merged" else [ci, in_w, in_h, 1, 1]
        return dict(path=PATHS[1] if split == 1 else PATHS[2], tile_w=-neg_tw, tile_h=th,
                    ring=ring, planes=planes, chunks=chunks, cluster=split,
                    grid=min(items, slots) * split, blocks_per_sm=bps, smem_bytes=smem,
                    map=layout, box=box, pitch=pitch, shift=shift, box_bytes=pitch * in_h, stage=stage,
                    in_w=in_w, in_h=in_h, kc=kc, items=items, rounds=rounds,
                    planes_per_pass=planes_per_pass(co, split),
                    plane_tiles=B * Do * n,
                    staged_bytes=split * B * n * chunks * pitch * in_h
                    * ((planes - 1) * stride + 3 if split == 1 else planes))
    return None


def plan(x_shape: Sequence[int], co: int, stride: int, pads, sms: int = H100_SMS,
         smem_optin: int = H100_SMEM_OPTIN, aligned: bool = True,
         path: Optional[str] = None) -> dict:
    """The launch plan of the int8 conv kernel for a (B, D, H, W, Ci) input, Co, stride and
    pads, on a card of `sms` SMs and `smem_optin` bytes of opt-in shared memory per block
    (an H100's by default), for an input whose base is 16-byte `aligned` or not.

    The path is chosen by shape, never on a failure:
      * "ring" where a tensor map describes the input (map_layout): Ci 8 (merged W*Ci,
        W*Ci a multiple of 16) or a multiple of 16, an aligned base;
      * "ring_cluster" instead where the ring plan has fewer than
        CLUSTER_PLANE_TILES_PER_SM output plane-tiles (B * Do * tiles) per SM: such classes
        cannot fill the card with a block per plane-tile, and the cluster gives each
        plane-tile three blocks with a third of the weights and the k-steps each. On the
        H100 (chip_smoke.py timing, fp32 out, us, cluster / one block) it won at 64
        plane-tiles, (1,16,15,28) 64->64 31.9 / 41.6 and (1,32,30,56) 32->64 s2 21.8 / 24.2,
        and lost at 448, (1,32,30,56) 32->32 31.0 / 21.2 and (1,64,60,112) 16->32 s2
        30.2 / 17.7: so the threshold is one plane-tile per SM;
      * "generic" otherwise.
    `path` forces one of the three (for timing and tests); it raises ValueError where
    that path cannot take the conv. The dict holds PLAN_FIELDS (what the C side takes and
    checks) and, for the record, the map layout, the box, the items, the rounds of the
    resident blocks and the bytes staged."""
    out = output_shape(x_shape, co, stride, pads)
    layout = map_layout(x_shape, aligned)
    if path is not None and path not in PATHS:
        raise ValueError(f"int8 conv plan: path must be one of {PATHS}, got {path!r}")
    choice = None
    if layout is not None and path in (None, "ring", "ring_cluster"):
        pw = pads[2][0]
        ring = _ring_plan(x_shape, co, stride, pw, out, 1, layout, sms, smem_optin)
        cluster = (_ring_plan(x_shape, co, stride, pw, out, CLUSTER, layout, sms, smem_optin)
                   if path in (None, "ring_cluster") else None)
        if path is None:
            few = ring is not None and ring["plane_tiles"] < CLUSTER_PLANE_TILES_PER_SM * sms
            choice = cluster if cluster is not None and (ring is None or few) else ring
        else:
            choice = ring if path == "ring" else cluster
    if choice is None and path in (None, "generic"):
        choice = _generic_plan(x_shape, co, stride, out, sms, smem_optin)
    if choice is None:
        raise ValueError(f"int8 conv: no {path or 'launch'} plan for {tuple(x_shape)} -> {co} "
                         f"channels at stride {stride} within {smem_optin} bytes of shared "
                         f"memory a block")
    return choice


def _plan_array(p: dict):
    values = [PATHS.index(p["path"])] + [int(p[k]) for k in PLAN_FIELDS[1:]]
    return (ctypes.c_int * len(PLAN_FIELDS))(*values)


def device_limits(device=None) -> tuple[int, int]:
    """(SMs, opt-in shared memory bytes per block) of a CUDA device, the planner's inputs."""
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _device_limits:
        res = (ctypes.c_int * 2)()
        with torch.cuda.device(index):
            err = _library().atvsnet_conv3d_int8_device(res)
        if err != 0:
            raise RuntimeError(f"conv3d_int8: device query failed: cudaError {err}")
        _device_limits[index] = (res[0], res[1])
    return _device_limits[index]


def launch_plan(x_shape, co: int, stride: int, pads, out_dtype=None, aligned: bool = True,
                path: Optional[str] = None) -> dict:
    """The plan a launch takes for this conv on the current CUDA device (`plan` with its
    limits), and the C side's check of it: `blocks_per_sm_device` (blocks of the plan's
    kernel that fit on an SM) and `clusters_device` (clusters that fit at once; 0 without
    one). Raises RuntimeError where the C side refuses the plan."""
    sms, smem = device_limits()
    p = plan(x_shape, co, stride, pads, sms=sms, smem_optin=smem, aligned=aligned, path=path)
    B, Do, Ho, Wo, _ = output_shape(x_shape, co, stride, pads)
    res = (ctypes.c_int * 2)()
    err = _library().atvsnet_conv3d_int8_check(B, *x_shape[1:], Do, Ho, Wo, co, stride,
                                               *(lo for lo, _ in pads), OUT_KINDS[out_dtype],
                                               _plan_array(p), res)
    if err != 0:
        raise RuntimeError(f"conv3d_int8: the kernel refuses the plan {p} for {tuple(x_shape)} "
                           f"-> {co} channels at stride {stride}: cudaError {err}")
    return dict(p, blocks_per_sm_device=res[0], clusters_device=res[1])


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


def _check_cuda(name: str, xq: torch.Tensor, wq: torch.Tensor, stride: int, pads, scale,
                out_dtype) -> None:
    _check(name, xq, wq, stride, pads, scale, out_dtype)
    tensors = [xq, wq] + ([] if scale is None else [scale])
    if any(t.device.type != "cuda" or t.device != xq.device for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not xq.is_contiguous():
        raise ValueError(f"{name}: xq must be contiguous")
    if wq.shape[0] > MAX_CO:
        raise ValueError(f"{name} takes at most {MAX_CO} output channels, got {wq.shape[0]}")
    shape = output_shape(xq.shape, wq.shape[0], stride, pads)
    if xq.numel() >= 2**31 or shape[0] * shape[1] * shape[2] * shape[3] >= 2**31:
        raise ValueError(f"{name}: volume too large, {tuple(xq.shape)}")


def launch(xq: torch.Tensor, wq: torch.Tensor, stride: int, pads, scale, out_dtype,
           p: dict) -> torch.Tensor:
    """Launch the kernel with plan `p` (from `plan`, for this conv on this device) and count
    the launch; raises RuntimeError where the C side refuses the plan."""
    _check_cuda("conv3d_int8_cuda", xq, wq, stride, pads, scale, out_dtype)
    return _launch(xq, wq, stride, pads, scale, out_dtype, p)


def _launch(xq, wq, stride, pads, scale, out_dtype, p):
    co = wq.shape[0]
    B, D, H, W, Ci = xq.shape
    shape = output_shape(xq.shape, co, stride, pads)
    # the generic kernel stages packed weights; the ring kernels gather them from wq
    wk = packed_weights(wq) if p["path"] == "generic" else wq.contiguous()
    out = torch.empty(shape, device=xq.device,
                      dtype=torch.int32 if out_dtype is None else out_dtype)
    with torch.cuda.device(xq.device):
        err = _library().atvsnet_conv3d_int8(
            xq.data_ptr(), wk.data_ptr(), None if scale is None else scale.data_ptr(),
            out.data_ptr(), B, D, H, W, Ci, shape[1], shape[2], shape[3], co, stride,
            pads[0][0], pads[1][0], pads[2][0], OUT_KINDS[out_dtype], _plan_array(p),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_int8 kernel launch failed for {tuple(xq.shape)} -> {co} "
                           f"channels at stride {stride} on the {p['path']} path: cudaError {err}")
    conv3d_int8_cuda.launches += 1
    conv3d_int8_cuda.path_launches[p["path"]] += 1
    key = (B, D, H, W, Ci, co, stride)
    conv3d_int8_cuda.shape_launches[key] = conv3d_int8_cuda.shape_launches.get(key, 0) + 1
    return out


def conv3d_int8_cuda(xq: torch.Tensor, wq: torch.Tensor, stride: int, pads,
                     scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """Plan and launch the CUDA kernel: xq, wq (and scale) int8 (fp32) contiguous CUDA
    tensors on one device -> the output, channel-last."""
    _check_cuda("conv3d_int8_cuda", xq, wq, stride, pads, scale, out_dtype)
    sms, smem = device_limits(xq.device)
    p = plan(xq.shape, wq.shape[0], stride, pads, sms=sms, smem_optin=smem,
             aligned=xq.data_ptr() % 16 == 0)
    return _launch(xq, wq, stride, pads, scale, out_dtype, p)


def empty_launch(xq: torch.Tensor, co: int, stride: int, pads, out_dtype, p: dict) -> None:
    """Launch an empty kernel on plan `p`'s grid (the same blocks, threads, shared memory and
    cluster) for this conv: its device time is what a launch of that grid costs. It moves
    no byte and counts as no launch."""
    B, Do, Ho, Wo, _ = output_shape(xq.shape, co, stride, pads)
    with torch.cuda.device(xq.device):
        err = _library().atvsnet_conv3d_int8_noop(B, *xq.shape[1:], Do, Ho, Wo, co, stride,
                                                  *(lo for lo, _ in pads), OUT_KINDS[out_dtype],
                                                  _plan_array(p),
                                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_int8 empty launch failed: cudaError {err}")


def conv3d_int8(xq: torch.Tensor, wq: torch.Tensor, stride: int, pads,
                scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if xq.device.type == "cuda":
        return conv3d_int8_cuda(xq, wq, stride, pads, scale, out_dtype)
    return conv3d_int8_torch(xq, wq, stride, pads, scale, out_dtype)


def reset_launch_counts() -> None:
    """Set the kernel's launch counts (total, per path and per shape) to 0."""
    conv3d_int8_cuda.launches = 0
    conv3d_int8_cuda.path_launches = dict.fromkeys(PATHS, 0)
    conv3d_int8_cuda.shape_launches = {}


reset_launch_counts()
