"""ops.conv3d_transpose_fp32: the route of every float32 3x3x3 stride-2 3D deconv in
"highest", its plain version, its plan, its autograd Function and its launch counters on the
CPU; the CUDA kernel on the card (tests marked `cuda`, which skip at run time without one).

The plain version is the route's call before the kernel (pass_conv_transpose in "highest",
then the SAME crop), so the CPU path computes what it did. The three classes of the
forward's deconvs (chip_smoke.DECONV3D_CLASSES: 64->32, 32->16, 16->8, each k3 stride 2)
appear below at reduced sizes, besides a depth split's block (crop begin 2 on D), batch 2,
odd sizes and channel counts off the vector path. `emulate_kernel` replays the kernel's
tiling in float64 (its blocks, zero-filled bricks with their low halo, weight slices, channel
groups, the parity taps and the masked stores), so the index arithmetic of
csrc/conv3d_transpose_fp32.cu is checked here against the float64 product. On the card the
kernel is held to the float64 product within KERNEL_BOUND(8 Ci) of the class's max sum
|a||b| (an output sums at most 8 Ci products): run there with `python -m pytest --noconftest
-q tests/test_torch_conv3d_transpose_fp32.py`.
"""

import math

import pytest
import torch

from chip_smoke import DECONV3D_CLASSES
from chip_smoke import conv2d_kernel_bound as KERNEL_BOUND
from chip_smoke import deconv3d_forward_launches as forward_launches
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import init_model
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import conv3d_transpose_fp32 as CT
from atvsnet_torch.ops.fp32_passes import ConvSpec, conv_exact, pass_conv_transpose

FORWARD = (0, 0, 0)   # TF-SAME on even sizes crops (0, 1): the begin is 0
SPLIT = (2, 0, 0)     # a depth split's block: its first plane is the left neighbour's last

# (name, x (B, D, H, W, Ci), Co, begs): every class of the forward at a reduced size (more
# than one block along each axis, ragged edges), then edges
CLASSES = [
    ("4_0 64->32", (1, 3, 9, 18, 64), 32, FORWARD),
    ("5_0 32->16", (1, 4, 10, 20, 32), 16, FORWARD),
    ("6_0 16->8", (1, 5, 12, 35, 16), 8, FORWARD),
]
IDS = [c[0] for c in CLASSES]
# past the classes: a depth split's block, batch 2 (pair_batch), odd sizes, Co not a
# multiple of 4 or of a thread's channels, Ci off the vector path, a 1-voxel input
EDGES = [
    ("depth split 16->8", (1, 4, 9, 17, 16), 8, SPLIT),
    ("depth split 32->16", (1, 3, 5, 9, 32), 16, SPLIT),
    ("batch 2 32->16", (2, 3, 9, 17, 32), 16, FORWARD),
    ("odd sizes 8->4", (1, 3, 7, 19, 8), 4, FORWARD),
    ("Co 5", (1, 2, 5, 6, 8), 5, FORWARD),
    ("Co 12", (1, 2, 5, 6, 16), 12, FORWARD),
    ("Ci 2, scalar path", (1, 3, 9, 17, 2), 8, FORWARD),
    ("Ci 6, scalar path", (1, 2, 4, 5, 6), 3, FORWARD),
    ("1 voxel", (3, 1, 1, 1, 4), 8, FORWARD),
]
EDGE_IDS = [e[0] for e in EDGES]
# every plan the kernel is built with (csrc/conv3d_transpose_fp32.cu DECONV3D_PLANS)
# as (tn, planes, groups, stages)
KERNEL_PLANS = [(2, 4, 4, 2)]
PLAN_IDS = [f"tn{t}-planes{m}-groups{g}-stages{s}" for t, m, g, s in KERNEL_PLANS]


def _operands(case, device="cpu", seed=0):
    _, xs, co, begs = case
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=device)
    w = torch.randn((xs[-1], co, 3, 3, 3), generator=g, device=device) / math.sqrt(8 * xs[-1])
    return x, w, begs


def _pre_change(x, w, begs):
    """The route's call before the kernel, as nn.layers.deconv made it: pass_conv_transpose
    in "highest" on the channel-first view, then the crop [b, b + o), o = 2n - b."""
    y = pass_conv_transpose(x.movedim(-1, 1), w, "highest", 2)
    outs = [2 * n - b for n, b in zip(x.shape[1:4], begs)]
    return y[(slice(None), slice(None)) + tuple(slice(b, b + o) for b, o in zip(begs, outs))
             ].movedim(1, -1)


def _exact(x, w, begs, magnitude=False):
    """float64 conv_exact of the transposed conv, then the crop."""
    spec = ConvSpec.of(3, 2, transposed=True)
    y = conv_exact(x.movedim(-1, 1), w, spec, magnitude=magnitude)["forward"]
    crop = tuple(slice(b, 2 * n) for n, b in zip(x.shape[1:4], begs))
    return y[(slice(None), slice(None)) + crop].movedim(1, -1)


def emulate_kernel(x, w, begs, p):
    """csrc/conv3d_transpose_fp32.cu's tiling replayed in float64 with plan p, every block at
    once: per block (a CW x CH tile of input cells along (w, h), `planes` cells along D, one
    batch) its brick of (planes + 1) x (CH + 1) x (CW + 1) positions starting one below the
    first cell's own input, zeros outside x; per input offset (dh, dw) and tap the brick
    values each thread reads (plane i + 1 - dd, row ty + 1 - dh, column tx + 1 - dw) times
    the tap's weights into the output parity the tap feeds; then the cells' outputs
    interleaved, those past the output dropped."""
    x, w = x.double(), w.double()
    B, D, H, W, ci = x.shape
    co = w.shape[1]
    (TW, TH), TMD = CT.block_cells(p["groups"]), p["planes"]
    e = [b // 2 for b in begs]
    M = [n - e_ for n, e_ in zip((D, H, W), e)]
    tiles = [-(-m // t) for m, t in zip(M, (TMD, TH, TW))]
    # x zero-padded by one below and past every tile above: brick position q of tile t reads
    # x[t * size + q + e - 1]
    xp = torch.zeros((B,) + tuple(t * s + e_ + 1 for t, s, e_ in zip(tiles, (TMD, TH, TW), e))
                     + (ci,), dtype=torch.float64)
    xp[:, 1:D + 1, 1:H + 1, 1:W + 1] = x
    idx = [(torch.arange(t)[:, None] * s + torch.arange(s + 1) + e_)
           for t, s, e_ in zip(tiles, (TMD, TH, TW), e)]
    brick = xp[:, idx[0][:, :, None, None, None, None], idx[1][None, None, :, :, None, None],
               idx[2][None, None, None, None]]          # (B, td, TMD+1, th, TH+1, tw, TW+1, ci)
    wt = w.reshape(ci, co, 3, 3, 3)
    cells = torch.zeros((B, tiles[0], TMD, tiles[1], TH, tiles[2], TW, 2, 2, 2, co),
                        dtype=torch.float64)
    for dh in range(2):
        for dw in range(2):
            for ph in range(2 - dh):
                kh = 2 if dh else ph
                for pw in range(2 - dw):
                    kw = 2 if dw else pw
                    for kd in range(3):
                        pd, dd = int(kd == 1), int(kd == 2)
                        v = brick[:, :, 1 - dd:TMD + 1 - dd, :, 1 - dh:TH + 1 - dh, :,
                                  1 - dw:TW + 1 - dw]
                        cells[..., pd, ph, pw, :] += v @ wt[:, :, kd, kh, kw]
    cells = cells.reshape(B, tiles[0] * TMD, tiles[1] * TH, tiles[2] * TW, 2, 2, 2, co)
    out = cells.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
        B, 2 * tiles[0] * TMD, 2 * tiles[1] * TH, 2 * tiles[2] * TW, co)
    return out[:, :2 * M[0], :2 * M[1], :2 * M[2]]


# ---- CPU ----

@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + EDGE_IDS)
def test_plain_is_the_pre_change_route(case):
    """The plain version equals the route's call before the kernel to the bit (crop begins
    (0, 0, 0) and (2, 0, 0)), and the float64 product within the kernel's bound."""
    x, w, begs = _operands(case)
    got = CT.conv3d_transpose_fp32_torch(x, w, begs)
    assert got.shape == CT.output_shape(x.shape, w.shape, begs)
    assert torch.equal(got, _pre_change(x, w, begs))
    scale = float(_exact(x, w, begs, magnitude=True).max())
    err = float((got.double() - _exact(x, w, begs)).abs().max())
    assert err <= KERNEL_BOUND(8 * x.shape[-1]) * scale


@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + EDGE_IDS)
def test_emulation_against_exact(case):
    """The kernel's tiling (emulate_kernel) in float64 equals the float64 product, with the
    plan the kernel would take, on both paths where Ci allows the vector one."""
    x, w, begs = _operands(case, seed=1)
    exact = _exact(x, w, begs)
    scale = float(_exact(x, w, begs, magnitude=True).max())
    for aligned in (True, False):
        p = CT.plan(x.shape[-1], w.shape[1], aligned=aligned)
        torch.testing.assert_close(emulate_kernel(x, w, begs, p), exact, rtol=1e-12,
                                   atol=1e-12 * scale)


@pytest.mark.parametrize("plan", KERNEL_PLANS, ids=PLAN_IDS)
def test_emulation_of_every_plan(plan):
    """Every plan the kernel is built with, replayed on a class, a split block and an odd
    edge: the float64 product."""
    tn, planes, groups, stages = plan
    for case in (CLASSES[2], EDGES[0], EDGES[4]):
        x, w, begs = _operands(case, seed=2)
        p = {"path": "vector", "tn": tn, "planes": planes, "groups": groups, "stages": stages}
        exact = _exact(x, w, begs)
        scale = float(_exact(x, w, begs, magnitude=True).max())
        torch.testing.assert_close(emulate_kernel(x, w, begs, p), exact, rtol=1e-12,
                                   atol=1e-12 * scale)


def test_plan_per_class():
    """The plan of each class (Ci, Co) of the forward; the planner reads nothing else, and
    every plan it can give is one the kernel is built with."""
    want = {(64, 32): ("vector", 2, 4, 4, 2), (32, 16): ("vector", 2, 4, 4, 2),
            (16, 8): ("vector", 2, 4, 4, 2)}
    assert {(ci, co) for (_, (_, ci, co)) in DECONV3D_CLASSES} == set(want)
    for (ci, co), (path, tn, planes, groups, stages) in want.items():
        assert CT.plan(ci, co) == {"path": path, "tn": tn, "planes": planes, "groups": groups,
                                   "stages": stages}
    assert CT.plan(16, 8, aligned=False)["path"] == "scalar"
    assert CT.plan(2, 8)["path"] == "scalar"
    for ci in range(1, 130):
        for co in range(1, 130):
            p = CT.plan(ci, co)
            assert (p["tn"], p["planes"], p["groups"], p["stages"]) in KERNEL_PLANS


@pytest.mark.parametrize("args, message", [
    ((torch.randn(1, 2, 3, 4, 8), torch.randn(8, 4, 3, 3, 3), (0, 0, 0)), "CUDA tensors"),
    ((torch.randn(1, 2, 3, 4, 8).double(), torch.randn(8, 4, 3, 3, 3).double(), (0, 0, 0)),
     "float32"),
    ((torch.randn(1, 3, 4, 8), torch.randn(8, 4, 3, 3), (0, 0)), r"\(B, D, H, W, Ci\)"),
    ((torch.randn(1, 2, 3, 4, 8), torch.randn(8, 4, 2, 2, 2), (0, 0, 0)), r"\(B, D, H, W, Ci\)"),
    ((torch.randn(1, 2, 3, 4, 8), torch.randn(4, 8, 3, 3, 3), (0, 0, 0)), r"\(B, D, H, W, Ci\)"),
    ((torch.randn(1, 2, 3, 4, 8), torch.randn(8, 4, 3, 3, 3), (1, 0, 0)), "even"),
    ((torch.randn(1, 2, 3, 4, 8), torch.randn(8, 4, 3, 3, 3), (0, -2, 0)), "even"),
    ((torch.randn(1, 2, 3, 4, 8), torch.randn(8, 4, 3, 3, 3), (0, 0)), "even"),
    ((torch.randn(1, 1, 3, 4, 8), torch.randn(8, 4, 3, 3, 3), (2, 0, 0)), "no output"),
])
def test_launcher_refuses(args, message):
    """The launcher raises on what the kernel does not take: CPU tensors, other dtypes,
    ranks, kernel shapes or weight layouts, odd or negative crop begins, an empty output."""
    with pytest.raises(ValueError, match=message):
        CT.conv3d_transpose_fp32_cuda(*args)


def _route_cases():
    x4 = torch.randn(1, 6, 8, 8)
    x5 = torch.randn(1, 4, 6, 8, 8)
    w2, w3 = torch.randn(8, 4, 3, 3), torch.randn(8, 4, 3, 3, 3)
    return [
        ("highest 3D deconv", lambda: L.deconv(x5, w3), 1),
        ("highest 3D deconv with relu", lambda: L.deconv(x5, w3, relu=True), 1),
        ("deconv_bn 3D", lambda: L.deconv_bn(x5, w3), 1),
        ("deconv_bn 3D int8mxu", lambda: L.deconv_bn(x5, w3, quant=L.ActQuant("int8mxu")), 1),
        ("high 3D deconv", lambda: L.deconv(x5, w3, precision="high"), 0),
        ("default 3D deconv", lambda: L.deconv(x5, w3, precision="default"), 0),
        ("bf16 3D deconv", lambda: L.deconv(x5.bfloat16(), w3), 0),
        ("stride 1 3D deconv", lambda: L.deconv(x5, w3, stride=1), 0),
        ("k2 3D deconv", lambda: L.deconv(x5, torch.randn(8, 4, 2, 2, 2)), 0),
        ("2D deconv", lambda: L.deconv(x4, w2), 0),
        ("3D conv", lambda: L.conv(x5, torch.randn(8, 8, 3, 3, 3)), 0),
    ]


@pytest.mark.parametrize("index", range(len(_route_cases())),
                         ids=[c[0] for c in _route_cases()])
def test_route(monkeypatch, index):
    """Which calls take ops.conv3d_transpose_fp32 (the kernel on CUDA): float32, 3D, 3x3x3,
    stride 2 and "highest"; not "high", "default", bf16, other strides or kernel sizes, 2D
    calls or convs."""
    _, fn, expected = _route_cases()[index]
    calls = []

    def record(x, w, begs):
        calls.append((tuple(x.shape), tuple(w.shape), tuple(begs)))
        return CT.conv3d_transpose_fp32(x, w, begs)

    monkeypatch.setattr(L, "conv3d_transpose_fp32", record)
    fn()
    assert len(calls) == expected


class _Split:
    """A stand-in DepthSplit of `size` ranks on rank 0: halo() puts a left neighbour's plane
    (here a fixed one) before the block, as the real one's all-reduce does."""

    def __init__(self, size, plane):
        self.size, self.plane = size, plane

    def halo(self, x, left, right):
        return torch.cat([self.plane.to(x.dtype)] * left + [x], dim=1)


def _deconv_before(x, w, stride=2, relu=False, split=None, precision="highest"):
    """nn.layers.deconv as it was before the kernel's route."""
    out_sizes = [stride * s for s in x.shape[1:-1]]
    begs = [L._same_pads(o, k, stride)[0] for o, k in zip(out_sizes, w.shape[2:])]
    if split is not None and x.ndim == 5:
        begs[0] = L._same_pads(out_sizes[0] * split.size, 3, stride)[0] + stride
        x = split.halo(x, left=1, right=0)
    if x.dtype == torch.float32:
        y = pass_conv_transpose(x.movedim(-1, 1), w.to(x.dtype), precision, stride)
    else:
        y = L._CONV_T[x.ndim - 2](x.movedim(-1, 1), w.to(x.dtype), stride=stride)
    y = y[(slice(None), slice(None)) + tuple(slice(b, b + o) for b, o in zip(begs, out_sizes))]
    y = y.movedim(1, -1)
    return L.activate(y) if relu else y


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("kind", ["3D", "3D relu", "3D split", "3D bf16", "2D", "3D Ci 2"])
def test_deconv_on_cpu_unchanged(precision, kind):
    """nn.layers.deconv on CPU tensors gives the bits it gave before the route, in every
    mode, with and without a depth split, in bf16 and in 2D."""
    g = torch.Generator().manual_seed(7)
    ci = 2 if kind == "3D Ci 2" else 8
    x = torch.randn((1, 3, 5, 7, ci) if kind != "2D" else (1, 5, 7, ci), generator=g)
    w = torch.randn((ci, 4, 3, 3, 3) if kind != "2D" else (ci, 4, 3, 3), generator=g)
    kw = {"precision": precision}
    if kind == "3D relu":
        kw["relu"] = True
    if kind == "3D split":
        kw["split"] = _Split(2, torch.randn((1, 1, 5, 7, ci), generator=g))
    if kind == "3D bf16":
        x = x.bfloat16()
    got = L.deconv(x, w, **kw)
    want = _deconv_before(x, w, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_cpu_calls_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the launcher: the route runs the plain version."""
    def refuse(*args):
        raise AssertionError("the kernel's launcher ran for a CPU tensor")

    monkeypatch.setattr(CT, "conv3d_transpose_fp32_cuda", refuse)
    x, w, begs = _operands(CLASSES[1])
    assert torch.equal(L.deconv(x, w), CT.conv3d_transpose_fp32_torch(x, w, begs))


@pytest.mark.parametrize("case", [CLASSES[0], CLASSES[2], EDGES[0], EDGES[2]],
                         ids=[IDS[0], IDS[2], EDGE_IDS[0], EDGE_IDS[2]])
def test_function_gradients_are_the_pre_change_route(monkeypatch, case):
    """ConvTranspose3dFp32Function's gradients (input, weight) equal the pre-change route's
    under autograd (pass_conv_transpose's "highest" backward through the crop's slice) to the
    bit; the launcher is stood in by the plain version on the CPU."""
    monkeypatch.setattr(CT, "conv3d_transpose_fp32_cuda", CT.conv3d_transpose_fp32_torch)
    x, w, begs = _operands(case, seed=3)
    a = [t.clone().requires_grad_() for t in (x, w)]
    t = [t.clone().requires_grad_() for t in (x, w)]
    y = CT.ConvTranspose3dFp32Function.apply(a[0], a[1], begs)
    want = _pre_change(t[0], t[1], begs)
    assert torch.equal(y, want)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    y.backward(g)
    want.backward(g)
    for got_leaf, want_leaf in zip(a, t):
        assert torch.equal(got_leaf.grad, want_leaf.grad)


def _stand_in_launches(monkeypatch):
    """The launcher's checks and launch stood in by the plain version on the CPU."""
    monkeypatch.setattr(CT, "_check", lambda *a: None)
    monkeypatch.setattr(CT, "_launch", lambda x, w, begs, p:
                        CT.conv3d_transpose_fp32_torch(x, w, begs).contiguous())


def test_launch_counters(monkeypatch):
    """launches, path_launches and shape_launches (x shape, w shape, begs) count each
    launch; reset_launch_counts clears them."""
    _stand_in_launches(monkeypatch)
    CT.reset_launch_counts()
    x8 = torch.randn(1, 2, 3, 4, 8)
    x2 = torch.randn(1, 2, 3, 4, 2)
    misaligned = torch.randn(x8.numel() + 1)[1:].view(x8.shape)
    w8, w2 = torch.randn(8, 4, 3, 3, 3), torch.randn(2, 4, 3, 3, 3)
    for x, w, begs in ((x8, w8, FORWARD), (x8, w8, FORWARD), (x2, w2, SPLIT),
                       (misaligned, w8, FORWARD)):
        CT.conv3d_transpose_fp32_cuda(x, w, begs)
    assert CT.conv3d_transpose_fp32_cuda.launches == 4
    assert CT.conv3d_transpose_fp32_cuda.path_launches == {"vector": 2, "scalar": 2}
    assert CT.conv3d_transpose_fp32_cuda.shape_launches == {
        ((1, 2, 3, 4, 8), (8, 4, 3, 3, 3), FORWARD): 3,
        ((1, 2, 3, 4, 2), (2, 4, 3, 3, 3), SPLIT): 1}
    CT.reset_launch_counts()
    assert CT.conv3d_transpose_fp32_cuda.launches == 0
    assert CT.conv3d_transpose_fp32_cuda.shape_launches == {}
    assert CT.conv3d_transpose_fp32_cuda.path_launches == {"vector": 0, "scalar": 0}


def test_forward_launch_counter_per_view_count(monkeypatch):
    """Over one 3-view forward the launch counter equals deconv3d_forward_launches(3): 21 a
    pair (CRM's 3 a U-Net pass in both directions, the refinement's 3). The route sends each
    to the Function, whose launcher is stood in on the CPU."""
    cfg = PipelineConfig(view_num=3, max_h=32, max_w=64, max_d=8)
    images, cams = synthetic_scene(view_num=3, H=32, W=64, D=8, seed=0)
    model = init_model(cfg, device="cpu")
    _stand_in_launches(monkeypatch)
    monkeypatch.setattr(L, "conv3d_transpose_fp32", lambda x, w, begs:
                        CT.ConvTranspose3dFp32Function.apply(x, w, tuple(begs)))
    CT.reset_launch_counts()
    with torch.no_grad():
        multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams), cfg)
    assert CT.conv3d_transpose_fp32_cuda.launches == forward_launches(3) == 42
    assert forward_launches(5) == 84 and forward_launches(8) == 147
    assert set(CT.conv3d_transpose_fp32_cuda.path_launches) == {"vector", "scalar"}
    CT.reset_launch_counts()


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU build)")
    return torch.device("cuda")


def _check_on_card(x, w, begs):
    got = CT.conv3d_transpose_fp32_cuda(x, w, begs)
    again = CT.conv3d_transpose_fp32_cuda(x, w, begs)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == CT.output_shape(x.shape, w.shape, begs)
    assert torch.equal(got, again)
    scale = float(_exact(x, w, begs, magnitude=True).max())
    err = float((got.double() - _exact(x, w, begs)).abs().max())
    assert err <= KERNEL_BOUND(8 * x.shape[-1]) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + EDGE_IDS)
def test_kernel_against_exact(cuda, case):
    """The kernel against the float64 product within KERNEL_BOUND(8 Ci) of max sum |a||b|, on
    the path the plan names; two calls give the same bits."""
    x, w, begs = _operands(case, device="cuda", seed=5)
    path = CT.plan(x.shape[-1], w.shape[1])["path"]
    before = CT.conv3d_transpose_fp32_cuda.path_launches[path]
    _check_on_card(x, w, begs)
    assert CT.conv3d_transpose_fp32_cuda.path_launches[path] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("plan", KERNEL_PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("case", [CLASSES[0], CLASSES[2], EDGES[0], EDGES[4], EDGES[6]],
                         ids=[IDS[0], IDS[2], EDGE_IDS[0], EDGE_IDS[4], EDGE_IDS[6]])
def test_kernel_every_plan(cuda, plan, case):
    """Every plan the kernel is built with, on both paths, against the float64 product."""
    x, w, begs = _operands(case, device="cuda", seed=6)
    tn, planes, groups, stages = plan
    path = CT.plan(x.shape[-1], w.shape[1])["path"]
    got = CT._launch(x, w, begs, {"path": path, "tn": tn, "planes": planes, "groups": groups,
                                  "stages": stages})
    torch.cuda.synchronize()
    scale = float(_exact(x, w, begs, magnitude=True).max())
    err = float((got.double() - _exact(x, w, begs)).abs().max())
    assert err <= KERNEL_BOUND(8 * x.shape[-1]) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(DECONV3D_CLASSES)),
                         ids=[c[0] for c in DECONV3D_CLASSES])
@pytest.mark.parametrize("batch, begs", [(1, FORWARD), (2, FORWARD), (1, SPLIT)],
                         ids=["forward", "batch 2", "split block"])
def test_kernel_full_size_classes(cuda, index, batch, begs):
    """Every class of the forward at its full size (480x896, D = 128), at batch 1 and 2 and
    as a depth split's block of half the planes and its halo plane (crop begin 2 on D)."""
    _, (xs, ci, co) = DECONV3D_CLASSES[index]
    xs = (batch,) + ((xs[1] // 2 + 1,) if begs == SPLIT else (xs[1],)) + tuple(xs[2:])
    x, w, _ = _operands(("", xs + (ci,), co, begs), device="cuda", seed=7)
    _check_on_card(x, w, begs)


@pytest.mark.cuda
def test_kernel_misaligned_input_takes_the_scalar_path(cuda):
    x, w, begs = _operands(CLASSES[2], device="cuda", seed=8)
    buf = torch.empty(x.numel() + 1, device="cuda")
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    before = CT.conv3d_transpose_fp32_cuda.path_launches["scalar"]
    got = CT.conv3d_transpose_fp32_cuda(shifted, w, begs)
    assert CT.conv3d_transpose_fp32_cuda.path_launches["scalar"] == before + 1
    scale = float(_exact(x, w, begs, magnitude=True).max())
    err = float((got.double() - _exact(x, w, begs)).abs().max())
    assert err <= KERNEL_BOUND(8 * x.shape[-1]) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CLASSES[0], CLASSES[2], EDGES[0], EDGES[2]],
                         ids=[IDS[0], IDS[2], EDGE_IDS[0], EDGE_IDS[2]])
def test_kernel_gradients_are_the_pre_change_route(cuda, case):
    """On the card the route's gradients to x and w are the pre-change route's to the bit
    (deterministic cuDNN), the forward within the kernel's bound."""
    torch.backends.cudnn.deterministic = True
    try:
        x, w, begs = _operands(case, device="cuda", seed=9)
        a = [t.clone().requires_grad_() for t in (x, w)]
        t = [t.clone().requires_grad_() for t in (x, w)]
        y = CT.conv3d_transpose_fp32(a[0], a[1], begs)
        want = _pre_change(t[0], t[1], begs)
        g = torch.randn(y.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(10))
        y.backward(g)
        want.backward(g)
        for got_leaf, want_leaf in zip(a, t):
            assert torch.equal(got_leaf.grad, want_leaf.grad)
        scale = float(_exact(x, w, begs, magnitude=True).max())
        err = float((y.detach().double() - _exact(x, w, begs)).abs().max())
        assert err <= KERNEL_BOUND(8 * x.shape[-1]) * scale
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize("views", [5, 8])
def test_forward_routes_every_highest_3d_deconv(cuda, views):
    """One N-view forward: every float32 3D deconv in "highest" is a launch of the kernel
    (21 a pair: 84 at 5 views, 147 at 8), and none under "default"."""
    cfg = PipelineConfig(view_num=views, max_h=64, max_w=96, max_d=16)
    images, cams = synthetic_scene(view_num=views, H=64, W=96, D=16, seed=0)
    model = init_model(cfg, device="cuda")
    for precision, expected in (("highest", forward_launches(views)), ("default", 0)):
        CT.reset_launch_counts()
        with torch.no_grad():
            multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams),
                               cfg.replace(fp32_precision=precision))
        torch.cuda.synchronize()
        assert CT.conv3d_transpose_fp32_cuda.launches == expected
    assert forward_launches(views) == {5: 84, 8: 147}[views]
