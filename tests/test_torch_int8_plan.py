"""The int8 conv kernel's launch planner (atvsnet_torch/ops/int8_conv.py `plan`), on the CPU.

The planner decides, by shape, which of the kernel's three paths a conv takes (ring,
ring_cluster, generic), and the tile, ring depth, D chunks, cluster and grid; the CUDA side
(csrc/int8_conv.cu) only checks the plan. These tests hold the plan to the tensor map's
rules and the card's limits at every shape class of the flagship int8mxu forward
(chip_smoke.INT8_MAIN_SHAPES), and emulate the decomposition the ring paths compute in plain
PyTorch: input planes taken from a ring of stages as the kernel's loads fill it, the
kernel's K-offset table with its wrap around the ring's end, the per-kd partial sums of a
cluster added up. On seeded int8 inputs the emulation equals conv3d_int8_torch to the bit.
No JAX here; the card's own checks are in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from atvsnet_torch.nn.layers import _same_pads
from atvsnet_torch.ops import int8_conv as I
from chip_smoke import INT8_MAIN_SHAPES, int8_kernel_cases, int8_pads

H100_SMEM_PER_BLOCK = 232_448


def _pads(shape, stride, halo=False):
    pads = [_same_pads(n, 3, stride) for n in shape[1:4]]
    return [(0, 0)] + pads[1:] if halo else pads


def _items(p, B, Do, Ho, Wo):
    """(b, od0, n_out, oh0, ow0) of every work item of a ring plan, in the kernel's order."""
    tiles_w, tiles_h = -(-Wo // p["tile_w"]), -(-Ho // p["tile_h"])
    out = []
    for item in range(p["items"]):
        tw, rest = item % tiles_w, item // tiles_w
        th, rest = rest % tiles_h, rest // tiles_h
        chunk, b = rest % p["chunks"], rest // p["chunks"]
        od0 = chunk * p["planes"]
        out.append((b, od0, min(p["planes"], Do - od0), th * p["tile_h"], tw * p["tile_w"]))
    assert len(out) == B * p["chunks"] * tiles_h * tiles_w
    return out


def _check_limits(p, x_shape, stride):
    B, D, H, W, Ci = x_shape
    assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
    assert p["grid"] % p["cluster"] == 0 and p["grid"] >= p["cluster"]
    assert all(1 <= e <= 256 for e in p["box"])
    assert p["box"][0] % 16 == 0                               # inner extent, bytes
    row = W * Ci
    strides = [row, row * H, row * H * D] if p["map"] == "merged" else [Ci, row, row * H, row * H * D]
    assert all(s % 16 == 0 for s in strides)
    assert p["box_bytes"] == int(np.prod(p["box"])) and p["stage"] % 128 == 0
    assert p["tile_w"] * p["tile_h"] == I.TILE_M
    assert p["in_w"] == (p["tile_w"] - 1) * stride + 3 and p["in_h"] == (p["tile_h"] - 1) * stride + 3
    least = 2 if p["cluster"] > 1 else I.LEAST_RING[stride]
    assert least <= p["ring"] <= I.MAX_RING


@pytest.mark.parametrize("key", list(INT8_MAIN_SHAPES), ids=lambda k: "x".join(map(str, k)))
def test_main_classes_take_a_ring_path_within_the_cards_limits(key):
    shape, co, stride = key[:5], key[5], key[6]
    pads = int8_pads(shape, stride)
    chosen = I.plan(shape, co, stride, pads)
    assert chosen["path"] in ("ring", "ring_cluster")
    for path in ("ring", "ring_cluster"):   # either, for the timing of both in chip_smoke
        p = I.plan(shape, co, stride, pads, path=path)
        assert p["path"] == path and p["cluster"] == (3 if path == "ring_cluster" else 1)
        assert p["map"] == ("merged" if shape[-1] == 8 else "5d")
        _check_limits(p, shape, stride)
    # the rule: the cluster where the ring has fewer plane-tiles than the threshold per SM
    ring = I.plan(shape, co, stride, pads, path="ring")
    few = ring["plane_tiles"] < I.CLUSTER_PLANE_TILES_PER_SM * I.H100_SMS
    assert chosen["path"] == ("ring_cluster" if few else "ring")


def test_the_flagship_classes_split_as_the_rule_says():
    """The two 28-launch classes with 64 plane-tiles, (1,32,30,56) 32->64 s2 and
    (1,16,15,28) 64->64, have under one plane-tile per SM and take the cluster; the rest
    stream on one block."""
    paths = {k: I.plan(k[:5], k[5], k[6], int8_pads(k[:5], k[6]))["path"] for k in INT8_MAIN_SHAPES}
    cluster = {k for k, v in paths.items() if v == "ring_cluster"}
    assert cluster == {(1, 32, 30, 56, 32, 64, 2), (1, 16, 15, 28, 64, 64, 1)}
    assert sum(INT8_MAIN_SHAPES[k] for k in cluster) == 56


def test_what_no_tensor_map_describes_takes_the_generic_path():
    """Ci 12 and 6 (no map layout), the odd sizes at Ci 8 (W * Ci = 88, no multiple of 16)
    and a base that is not 16-byte aligned go generic; the odd sizes at Ci 16 are a 5-D
    map's and stream on a ring (the cluster's: 63 plane-tiles)."""
    want = {"odd sizes s1": "ring_cluster", "odd sizes s2": "generic",
            "Ci 12, 4-byte loads": "generic", "Ci 6, byte loads": "generic"}
    cases = {c[0]: c for c in int8_kernel_cases()}
    for name, path in want.items():
        _, shape, co, stride, halo = cases[name]
        p = I.plan(shape, co, stride, int8_pads(shape, stride, halo))
        assert p["path"] == path, name
    _, shape, co, stride, _ = cases["main 1x128x120x224x8->8 s1"]
    assert I.plan(shape, co, stride, int8_pads(shape, stride), aligned=False)["path"] == "generic"
    with pytest.raises(ValueError):
        I.plan((1, 6, 5, 7, 6), 3, 1, [(1, 1)] * 3, path="ring")


@pytest.mark.parametrize("case", int8_kernel_cases(), ids=lambda c: c[0])
def test_d_chunks_cover_every_output_plane_once(case):
    _, shape, co, stride, halo = case
    pads = int8_pads(shape, stride, halo)
    B, Do, Ho, Wo, _ = I.output_shape(shape, co, stride, pads)
    for path in ("ring", "ring_cluster"):
        try:
            p = I.plan(shape, co, stride, pads, path=path)
        except ValueError:
            assert I.map_layout(shape) is None
            continue
        assert (p["chunks"] - 1) * p["planes"] < Do <= p["chunks"] * p["planes"]
        seen = np.zeros((B, Do, Ho, Wo), np.int64)
        for b, od0, n, oh0, ow0 in _items(p, B, Do, Ho, Wo):
            assert n >= 1
            seen[b, od0:od0 + n, oh0:oh0 + p["tile_h"], ow0:ow0 + p["tile_w"]] += 1
        assert (seen == 1).all()


# ---- a plain emulation of the ring paths' decomposition ----

def _box(xq, p, b, d, h0, w0):
    """One TMA load: the (in_h, pitch) bytes of input plane d from row h0 and column w0
    (negative or past the end: zeros, as the map's out-of-bounds fill), flat in a stage."""
    B, D, H, W, Ci = xq.shape
    stage = torch.zeros(p["stage"], dtype=torch.int64)
    if not 0 <= d < D:
        return stage
    hh = h0 + torch.arange(p["in_h"])
    if p["map"] == "merged":   # bytes w0 * Ci - shift .. of the (H, W * Ci) plane
        assert (w0 * Ci - p["shift"]) % 16 == 0                 # a 16-byte aligned start
        jj = w0 * Ci - p["shift"] + torch.arange(p["pitch"])
        plane = xq[b, d].reshape(H, W * Ci).to(torch.int64)
        ok = ((hh >= 0) & (hh < H))[:, None] & ((jj >= 0) & (jj < W * Ci))[None, :]
        rows = plane[hh.clamp(0, H - 1)][:, jj.clamp(0, W * Ci - 1)]
    else:                      # voxels w0 .. of the (H, W, Ci) plane, all channels
        ww = w0 + torch.arange(p["in_w"])
        ok = ((hh >= 0) & (hh < H))[:, None, None] & ((ww >= 0) & (ww < W))[None, :, None]
        rows = xq[b, d].to(torch.int64)[hh.clamp(0, H - 1)][:, ww.clamp(0, W - 1)]
        ok, rows = ok.expand_as(rows).reshape(p["in_h"], -1), rows.reshape(p["in_h"], -1)
    stage[:p["box_bytes"]] = (rows * ok).reshape(-1)
    return stage


def emulate_ring_plan(xq, wq, stride, pads, p):
    """The int32 sums that plan `p` (ring or ring_cluster) computes, in plain PyTorch: each
    persistent block (a cluster: each of its ranks) walks its items with the grid's stride,
    in passes of p["planes_per_pass"] output planes, keeps a ring of
    p["ring"] stages filled by the kernel's rule (loads up to `ring` ahead of the first stage
    still in use after a pass), reads each output plane's window through the K-offset
    table (one entry per 8 values of K: kd * stage + kh * pitch + kw * Ci + ci, the group
    wrapping once at the ring's end) and the
    tile's row offsets, multiplies it with its rank's block of the packed weights; the
    ranks' partial sums are added."""
    B, D, H, W, Ci = xq.shape
    co = wq.shape[0]
    _, Do, Ho, Wo, _ = I.output_shape(xq.shape, co, stride, pads)
    (pd, _), (ph, _), (pw, _) = pads
    split, S, stage, kc = p["cluster"], p["ring"], p["stage"], p["kc"]
    # each rank's weights as the kernel gathers them: packed_weights' columns of its taps
    # (all 27, or the 9 of its kd), zero past them to kc
    packed = I.packed_weights(wq).to(torch.int64)
    taps = 27 if split == 1 else 9
    wk = torch.cat([F.pad(packed[:, 9 * r * Ci:(9 * r + taps) * Ci], (0, kc - taps * Ci))
                    for r in range(split)], 1)
    k = torch.arange(0, kc, 8)                                 # a group of 8 values of K
    tap, ci = k // Ci, k % Ci
    kd = tap // 9 if split == 1 else torch.zeros_like(tap)
    offs = torch.where(k < (27 if split == 1 else 9) * Ci,
                       kd * stage + (tap % 9 // 3) * p["pitch"] + (tap % 3) * Ci + ci, 0)
    offs = (offs[:, None] + torch.arange(8)).reshape(-1)       # per value of K
    m = torch.arange(I.TILE_M)
    rows, cols = m // p["tile_w"], m % p["tile_w"]
    base = rows * stride * p["pitch"] + p["shift"] + cols * stride * Ci
    items = _items(p, B, Do, Ho, Wo)
    blocks = p["grid"] // split
    acc = torch.zeros((B, Do, Ho, Wo, wk.shape[0]), dtype=torch.int64)

    def n_loads(n_out):
        return (n_out - 1) * stride + 3 if split == 1 else n_out

    for blk in range(blocks):
        for rank in range(split):
            ring = torch.zeros(S * stage, dtype=torch.int64)
            held = [-1] * S                       # the load each stage holds
            prod = {"item": blk, "q": 0, "next": 0}

            def top_up(limit):
                while prod["next"] < limit and prod["item"] < len(items):
                    b, od0, n_out, oh0, ow0 = items[prod["item"]]
                    q = prod["q"]
                    d = od0 * stride - pd + q if split == 1 else (od0 + q) * stride - pd + rank
                    slot = prod["next"] % S
                    ring[slot * stage:(slot + 1) * stage] = _box(
                        xq, p, b, d, oh0 * stride - ph, ow0 * stride - pw)
                    held[slot] = prod["next"]
                    prod["next"] += 1
                    prod["q"] += 1
                    if prod["q"] == n_loads(n_out):
                        prod["q"], prod["item"] = 0, prod["item"] + blocks

            top_up(S)
            first_load = 0
            step = stride if split == 1 else 1
            pair = p["planes_per_pass"]
            for item in range(blk, len(items), blocks):
                b, od0, n_out, oh0, ow0 = items[item]
                for j in range(0, n_out, pair):
                    planes = min(pair, n_out - j)
                    first = first_load + j * step
                    last = first + (2 if split == 1 else 0) + (planes - 1) * step
                    for load in range(first, last + 1):   # the pass's windows are in the ring
                        assert held[load % S] == load
                    for w in range(planes):
                        addr = ((first + w * step) % S) * stage + offs
                        if split == 1:
                            addr = torch.where(addr >= S * stage, addr - S * stage, addr)
                        a = ring[base[:, None] + addr[None, :]]                 # (M, kc)
                        part = a @ wk[:, rank * kc:(rank + 1) * kc].T            # (M, np)
                        oh, ow = oh0 + rows, ow0 + cols
                        inside = (oh < Ho) & (ow < Wo)
                        acc[b, od0 + j + w, oh[inside], ow[inside]] += part[inside]
                    released = (first_load + n_loads(n_out) if j + pair >= n_out
                                else first + pair * step)
                    top_up(released + S)
                first_load += n_loads(n_out)
    return acc[..., :co].to(torch.int32)


EMULATED = [  # (input shape, Co, stride, halo): Ci 8 on the merged map, 16/32/64 on the 5-D
    ((1, 7, 9, 12, 8), 8, 1, False),        # odd D
    ((1, 9, 10, 14, 8), 16, 2, False),      # odd D at stride 2
    ((1, 6, 8, 10, 16), 16, 1, True),       # a depth block with its halo, D pads (0, 0)
    ((1, 7, 6, 10, 16), 32, 2, True),
    ((4, 5, 6, 8, 8), 1, 1, False),         # B = 4, Co = 1
    ((1, 5, 7, 9, 32), 64, 2, False),       # Co = 64
    ((2, 4, 5, 6, 64), 64, 1, False),
    ((1, 3, 20, 34, 8), 8, 1, False),       # ragged last tiles along W and H
]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("path", ["ring", "ring_cluster"])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "x".join(map(str, c[0])) + f"-{c[1]}s{c[2]}")
def test_ring_decomposition_equals_the_plain_conv(case, path, sms):
    shape, co, stride, halo = case
    pads = _pads(shape, stride, halo)
    rng = np.random.default_rng(hash((shape, co, stride)) % 2**32)
    xq = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (co, shape[-1], 3, 3, 3), dtype=np.int8))
    p = I.plan(shape, co, stride, pads, sms=sms, path=path)
    want = I.conv3d_int8_torch(xq, wq, stride, pads)
    assert torch.equal(emulate_ring_plan(xq, wq, stride, pads, p), want)
