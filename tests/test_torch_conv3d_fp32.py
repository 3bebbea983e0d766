"""ops.conv3d_fp32: the route of every float32 3x3x3 3D conv with groups 1 in "highest", its
plain version, its plan, its autograd Function and its launch counters on the CPU; the CUDA
kernel on the card (tests marked `cuda`, which skip at run time without one).

The plain version is the route's call before the kernel (pass_conv on the padded
channel-first view), so the CPU path computes what it did. Each class of the 5-view
forward's 3D convs (CRM, the refinement, AAM; chip_smoke.CONV3D_CLASSES) appears below at a
reduced size with its channels, stride and pads, besides the depth split's halo'd blocks
((0, 0) on D) and odd sizes. `emulate_kernel` replays the kernel's tiling in float64 (its
blocks, bricks with their stride-2 column order, zero-filled halos, weight slices, channel
groups and masked stores), so the index arithmetic of csrc/conv3d_fp32.cu is checked here
against the float64 product. On the card the kernel is held to the float64 product at every
class at full size within KERNEL_BOUND(K) of the class's max sum |a||b| (conv_exact with
magnitude=True): run there with `python -m pytest --noconftest -q
tests/test_torch_conv3d_fp32.py`.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import CONV3D_CLASSES
from chip_smoke import conv2d_kernel_bound as KERNEL_BOUND
from chip_smoke import conv3d_forward_launches as forward_launches
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import init_model
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import conv3d_fp32 as C
from atvsnet_torch.ops.fp32_passes import ConvSpec, conv_exact, pass_conv

S1 = ((1, 1),) * 3
SAME_S2 = ((0, 1),) * 3            # TF-SAME, k3 stride 2 on even sizes
SPLIT_S1 = ((0, 0), (1, 1), (1, 1))  # a depth split's block with its two halo planes
SPLIT_S2 = ((0, 0), (0, 1), (0, 1))  # ... with its right halo plane, stride 2

# (name, x (B, D, H, W, Ci), Co, stride, pads, bias): every class of the forward at a
# reduced size (more than one block along each axis, ragged edges), then edges
CLASSES = [
    ("CRM entry 32->8", (1, 9, 10, 20, 32), 8, 1, S1, False),
    ("AAM [unique | shared] 8->16 B4", (4, 6, 9, 17, 8), 16, 1, S1, False),
    ("refine photo entry 16->8", (1, 9, 10, 20, 16), 8, 1, S1, False),
    ("CRM 32->16 s2", (1, 8, 18, 34, 32), 16, 2, SAME_S2, False),
    ("8->8", (1, 9, 10, 20, 8), 8, 1, S1, False),
    ("8->16 s2", (1, 6, 18, 34, 8), 16, 2, SAME_S2, False),
    ("prob 8->1", (1, 9, 10, 20, 8), 1, 1, S1, False),
    ("refine geo entry 2->8", (1, 9, 10, 20, 2), 8, 1, S1, False),
    ("vis-hull entry 1->8", (1, 9, 10, 20, 1), 8, 1, S1, False),
    ("16->16", (1, 5, 9, 17, 16), 16, 1, S1, False),
    ("16->32 s2", (1, 6, 10, 18, 16), 32, 2, SAME_S2, False),
    ("32->32", (1, 5, 9, 17, 32), 32, 1, S1, False),
    ("32->64 s2", (1, 4, 6, 8, 32), 64, 2, SAME_S2, False),
    ("64->64", (1, 3, 4, 7, 64), 64, 1, S1, False),
]
IDS = [c[0] for c in CLASSES]
# past the classes: odd sizes at stride 2 (TF-SAME (1, 1)), depth split blocks, Co not a
# multiple of 4 with a bias, Co over one channel group, a 1-voxel input, a misfit Ci
EDGES = [
    ("odd sizes s2", (1, 7, 9, 17, 8), 16, 2, S1, False),
    ("depth split 8->8", (1, 6, 9, 17, 8), 8, 1, SPLIT_S1, False),
    ("depth split 32->16 s2", (1, 5, 10, 18, 32), 16, 2, SPLIT_S2, False),
    ("Co 5 with bias", (2, 4, 5, 6, 8), 5, 1, S1, True),
    ("Co 24 with bias", (1, 4, 5, 19, 16), 24, 1, S1, True),
    ("1 voxel s2", (3, 1, 1, 1, 32), 64, 2, S1, True),
    ("Ci 6, Co 1 s2", (1, 5, 6, 7, 6), 1, 2, SAME_S2, False),
]


def _operands(case, device="cpu", seed=0):
    _, xs, co, stride, pads, biased = case
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=device)
    w = torch.randn((co, xs[-1], 3, 3, 3), generator=g, device=device) / math.sqrt(27 * xs[-1])
    b = torch.randn(co, generator=g, device=device) if biased else None
    return x, w, b, stride, pads


def _exact(x, w, b, stride, pads, magnitude=False):
    """float64 conv_exact of the explicitly padded channel-first operands (+ the bias)."""
    xc = F.pad(x.movedim(-1, 1), [p for lo, hi in reversed(pads) for p in (lo, hi)])
    y = conv_exact(xc, w, ConvSpec.of(3, stride, 0, 1), magnitude=magnitude)["forward"]
    if b is not None:
        y = y + (b.abs() if magnitude else b).double()[:, None, None, None]
    return y.movedim(1, -1)


def emulate_kernel(x, w, b, stride, pads, p):
    """csrc/conv3d_fp32.cu's tiling replayed in float64 with plan p: per block (a 16 x 8
    column tile, `planes` output planes, one batch, `tn` channels) and per channel group
    (4 on the vector path, 1 on the scalar one), its zero-filled brick stored as the kernel
    stores it (columns evens first at stride 2) and its weights as [tap][ci][co]; then per
    (kh, kw) each thread's column of input vectors along D, per (kd, ci) its multiply-adds;
    stores only inside the output."""
    x, w = x.double(), w.double()
    B, D, H, W, ci = x.shape
    co = w.shape[0]
    S, (TW, TH), TMD, TN = stride, C.BLOCK, p["planes"], p["tn"]
    CG = 4 if p["path"] == "vector" else 1
    _, Do, Ho, Wo, _ = C.output_shape(x.shape, w.shape, stride, pads)
    PD, PH, PW = (TMD - 1) * S + 3, (TH - 1) * S + 3, (TW - 1) * S + 3
    PWE = (PW + 1) // 2
    col = torch.tensor([c if S == 1 else (PWE + c // 2 if c % 2 else c // 2) for c in range(PW)])
    tx, ty = torch.arange(TW), torch.arange(TH)
    out = torch.zeros(B, Do, Ho, Wo, co, dtype=torch.float64)
    tiles_w, tiles_h, tiles_d = -(-Wo // TW), -(-Ho // TH), -(-Do // TMD)
    groups, G = -(-co // TN), -(-ci // CG)
    wflat = w.reshape(co, ci, 27)
    for bx in range(tiles_w * tiles_h):
        tile_w, tile_h = bx % tiles_w, bx // tiles_w
        for tile_d in range(tiles_d):
            for bz in range(B * groups):
                group, b_ = bz % groups, bz // groups
                od0, oh0, ow0, n0 = tile_d * TMD, tile_h * TH, tile_w * TW, group * TN
                idx = [torch.arange(n) + o * S - lo for n, o, (lo, _) in
                       zip((PD, PH, PW), (od0, oh0, ow0), pads)]
                inside = [(i >= 0) & (i < n) for i, n in zip(idx, (D, H, W))]
                acc = torch.zeros(TMD, TH, TW, TN, dtype=torch.float64)
                for g in range(G):
                    c0 = g * CG
                    brick = torch.zeros(PD, PH, PW, CG, dtype=torch.float64)
                    block = x[b_][idx[0].clamp(0, D - 1)][:, idx[1].clamp(0, H - 1)][
                        :, :, idx[2].clamp(0, W - 1), c0:c0 + CG]
                    mask = inside[0][:, None, None] & inside[1][None, :, None] & inside[2]
                    brick[:, :, col] = block * mask[..., None]
                    wts = torch.zeros(27, CG, TN, dtype=torch.float64)
                    nn = min(TN, co - n0)
                    wts[:, :, :nn] = wflat[n0:n0 + nn, c0:c0 + CG].permute(2, 1, 0)
                    for khw in range(9):
                        kh, kw = divmod(khw, 3)
                        r = ty * S + kh
                        cidx = tx + kw if S == 1 else (PWE + tx if kw == 1 else tx + kw // 2)
                        v = brick[:, r][:, :, cidx]                # (PD, TH, TW, CG)
                        for kd in range(3):
                            planes = v[torch.arange(TMD) * S + kd]  # (TMD, TH, TW, CG)
                            for c in range(CG):
                                acc += planes[..., c, None] * wts[kd * 9 + khw, c]
                nd, nh, nw = min(TMD, Do - od0), min(TH, Ho - oh0), min(TW, Wo - ow0)
                nn = min(TN, co - n0)
                res = acc[:nd, :nh, :nw, :nn]
                if b is not None:
                    res = res + b.double()[n0:n0 + nn]
                out[b_, od0:od0 + nd, oh0:oh0 + nh, ow0:ow0 + nw, n0:n0 + nn] = res
    return out


# ---- CPU ----

@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + [e[0] for e in EDGES])
def test_plain_and_emulation_against_exact(case):
    """The plain version equals pass_conv on the explicitly padded operands within the
    kernel's bound of the float64 product; the kernel's tiling (emulate_kernel with the plan
    the kernel would take) in float64 equals the float64 product; at every class, stride 1 and
    2 on odd and even sizes, the depth split's (0, 0) D pads, batch 4, Ci 1/2/6/8/16/32/64,
    Co 1/5/8/16/24/32/64."""
    x, w, b, stride, pads = _operands(case)
    got = C.conv3d_fp32_torch(x, w, b, stride, 1, pads)
    xc = F.pad(x.movedim(-1, 1), [p for lo, hi in reversed(pads) for p in (lo, hi)])
    want = pass_conv(xc, w, "highest", stride, 0, 1, 1, b).movedim(1, -1)
    assert got.shape == C.output_shape(x.shape, w.shape, stride, pads)
    assert torch.equal(got, want)
    exact = _exact(x, w, b, stride, pads)
    scale = float(_exact(x, w, b, stride, pads, magnitude=True).max())
    assert float((got.double() - exact).abs().max()) <= KERNEL_BOUND(27 * x.shape[-1]) * scale
    for aligned in (True, False):
        p = C.plan(x.shape[-1], w.shape[0], stride, aligned=aligned)
        emulated = emulate_kernel(x, w, b, stride, pads, p)
        torch.testing.assert_close(emulated, exact, rtol=1e-12, atol=1e-12 * scale)


def test_plan_per_class():
    """The plan of each class (Ci, Co, stride) of the forward: path, channels and planes a
    thread, stages; the planner reads nothing else."""
    want = {(32, 8, 1): ("vector", 8, 8, 2), (8, 16, 1): ("vector", 16, 4, 2),
            (16, 8, 1): ("vector", 8, 8, 2), (32, 16, 2): ("vector", 16, 2, 1),
            (8, 8, 1): ("vector", 8, 8, 2), (8, 16, 2): ("vector", 16, 2, 1),
            (8, 1, 1): ("vector", 1, 8, 2), (2, 8, 1): ("scalar", 8, 8, 2),
            (1, 8, 1): ("scalar", 8, 8, 2), (16, 16, 1): ("vector", 16, 4, 2),
            (16, 32, 2): ("vector", 16, 2, 1), (32, 32, 1): ("vector", 8, 4, 2),
            (32, 64, 2): ("vector", 8, 2, 1), (64, 64, 1): ("vector", 8, 2, 2)}
    assert {(ci, co, s) for (_, (_, ci, co, s)) in CONV3D_CLASSES} == set(want)
    for (ci, co, s), (path, tn, planes, stages) in want.items():
        assert C.plan(ci, co, s) == {"path": path, "tn": tn, "planes": planes,
                                     "stages": stages}
    assert C.plan(32, 8, 1, aligned=False)["path"] == "scalar"
    assert C.plan(6, 1, 2) == {"path": "scalar", "tn": 8, "planes": 2, "stages": 1}
    # every plan the planner can give is one of the kernel's instantiations
    kernels = {(1, 1, 8, 2), (1, 8, 8, 2), (1, 8, 4, 2), (1, 8, 2, 2), (1, 16, 4, 2),
               (2, 8, 2, 1), (2, 16, 2, 1)}
    for ci in range(1, 130):
        for co in range(1, 130):
            for s in (1, 2):
                p = C.plan(ci, co, s)
                assert (s, p["tn"], p["planes"], p["stages"]) in kernels


def _route_cases():
    x4 = torch.randn(1, 6, 8, 8)
    x5 = torch.randn(1, 4, 6, 8, 8)
    w2, w3 = torch.randn(8, 8, 3, 3), torch.randn(8, 8, 3, 3, 3)
    quant = L.ActQuant("int8mxu")
    return [
        ("highest 3D conv", lambda: L.conv(x5, w3), 1),
        ("highest 3D conv stride 2 with relu", lambda: L.conv(x5, w3, stride=2, relu=True), 1),
        ("conv_bn 3D", lambda: L.conv_bn(x5, w3), 1),
        ("3D conv with bias", lambda: L.conv(x5, w3, torch.randn(8)), 1),
        ("conv3d_mixed: its 3D half", lambda: L.conv3d_mixed(
            torch.randn(8, 12, 3, 3, 3), x5, torch.randn(1, 6, 8, 4)), 1),
        ("int8mxu qin 3D conv", lambda: L.conv(x5, w3, quant=quant, qin=True), 0),
        ("int8mxu 3D conv not qin", lambda: L.conv(x5, w3, quant=quant), 1),
        ("high 3D conv", lambda: L.conv(x5, w3, precision="high"), 0),
        ("default 3D conv", lambda: L.conv(x5, w3, precision="default"), 0),
        ("bf16 3D conv", lambda: L.conv(x5.bfloat16(), w3), 0),
        ("3D deconv", lambda: L.deconv(x5, w3), 0),
        ("1x1x1 3D conv", lambda: L.conv(x5, torch.randn(8, 8, 1, 1, 1)), 0),
        ("2D conv", lambda: L.conv(x4, w2), 0),
    ]


@pytest.mark.parametrize("index", range(len(_route_cases())),
                         ids=[c[0] for c in _route_cases()])
def test_route(monkeypatch, index):
    """Which calls take ops.conv3d_fp32 (the kernel on CUDA): float32, 3D, 3x3x3, groups 1 and
    "highest"; not the int8mxu qin convs, "high", "default", bf16, transposed, other kernel
    sizes or 2D calls."""
    _, fn, expected = _route_cases()[index]
    calls = []

    def record(x, w, b, stride, rate, pads):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return C.conv3d_fp32(x, w, b, stride, rate, pads)

    monkeypatch.setattr(L, "conv3d_fp32", record)
    fn()
    assert len(calls) == expected


def test_cpu_calls_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the launcher: the route runs the plain version, the call
    it made before the kernel, to the bit."""
    def refuse(*args):
        raise AssertionError("the kernel's launcher ran for a CPU tensor")

    monkeypatch.setattr(C, "conv3d_fp32_cuda", refuse)
    x, w = torch.randn(1, 6, 9, 11, 8), torch.randn(16, 8, 3, 3, 3)
    pads = [L._same_pads(s, 3, 2) for s in x.shape[1:4]]
    got = L.conv(x, w, stride=2)
    assert torch.equal(got, C.conv3d_fp32_torch(x, w, None, 2, 1, pads))


@pytest.mark.parametrize("case", [CLASSES[i] for i in (0, 3, 7)] + [EDGES[2], EDGES[3]],
                         ids=[IDS[i] for i in (0, 3, 7)] + [EDGES[2][0], EDGES[3][0]])
def test_function_gradients_are_pass_convs(monkeypatch, case):
    """Conv3dFp32Function's gradients (input, weight, bias) equal the plain version's under
    autograd (pass_conv's "highest" backward through F.pad) to the bit; the launcher is
    stood in by the plain version on the CPU."""
    monkeypatch.setattr(C, "conv3d_fp32_cuda", C.conv3d_fp32_torch)
    x, w, b, stride, pads = _operands(case, seed=1)
    operands = (x, w) + (() if b is None else (b,))
    leaves = [t.clone().requires_grad_() for t in operands]
    twins = [t.clone().requires_grad_() for t in operands]
    bias, bias_twin = (leaves[2], twins[2]) if b is not None else (None, None)
    y = C.Conv3dFp32Function.apply(leaves[0], leaves[1], bias, stride, 1, pads)
    want = C.conv3d_fp32_torch(twins[0], twins[1], bias_twin, stride, 1, pads)
    assert torch.equal(y, want)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    y.backward(g)
    want.backward(g)
    for got_leaf, want_leaf in zip(leaves, twins):
        assert torch.equal(got_leaf.grad, want_leaf.grad)


def _stand_in_launches(monkeypatch):
    """The launcher's checks and launch stood in by the plain version on the CPU."""
    monkeypatch.setattr(C, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(C, "_launch", lambda x, w, bias, stride, pads, p:
                        C.conv3d_fp32_torch(x, w, bias, stride, 1, pads))


def test_launch_counters(monkeypatch):
    """launches, path_launches and shape_launches (x shape, w shape, stride, pads) count each
    launch; reset_launch_counts clears them."""
    _stand_in_launches(monkeypatch)
    C.reset_launch_counts()
    x8 = torch.randn(1, 4, 6, 8, 8)
    x2 = torch.randn(1, 4, 6, 8, 2)
    misaligned = torch.randn(x8.numel() + 1)[1:].view(x8.shape)
    w8, w2 = torch.randn(16, 8, 3, 3, 3), torch.randn(8, 2, 3, 3, 3)
    for x, w in ((x8, w8), (x8, w8), (x2, w2), (misaligned, w8)):
        C.conv3d_fp32_cuda(x, w, None, 1, 1, S1)
    assert C.conv3d_fp32_cuda.launches == 4
    assert C.conv3d_fp32_cuda.path_launches == {"vector": 2, "scalar": 2}
    assert C.conv3d_fp32_cuda.shape_launches == {
        ((1, 4, 6, 8, 8), (16, 8, 3, 3, 3), 1, S1): 3, ((1, 4, 6, 8, 2), (8, 2, 3, 3, 3), 1, S1): 1}
    C.reset_launch_counts()
    assert C.conv3d_fp32_cuda.launches == 0 and C.conv3d_fp32_cuda.shape_launches == {}
    assert C.conv3d_fp32_cuda.path_launches == {"vector": 0, "scalar": 0}


def test_forward_launch_counter_per_view_count(monkeypatch):
    """Over one 3-view forward the launch counter equals the float32 3D convs the forward
    makes in "highest" (counted at _padded_conv) and conv3d_forward_launches(3): 4 + 56 a
    pair. The route sends each to the Function, whose launcher is stood in on the CPU."""
    cfg = PipelineConfig(view_num=3, max_h=32, max_w=64, max_d=8)
    images, cams = synthetic_scene(view_num=3, H=32, W=64, D=8, seed=0)
    model = init_model(cfg, device="cpu")
    _stand_in_launches(monkeypatch)
    monkeypatch.setattr(L, "conv3d_fp32", lambda x, w, b, s, r, pads: C.Conv3dFp32Function.apply(
        x, w, b, s, r, tuple(tuple(q) for q in pads)))
    eligible = []
    real = L._padded_conv

    def count(x, w, b, stride, rate, pads, groups=1, precision="highest"):
        if x.dtype == torch.float32 and x.ndim == 5 and groups == 1 and precision == "highest":
            eligible.append(tuple(x.shape))
        return real(x, w, b, stride, rate, pads, groups, precision)

    monkeypatch.setattr(L, "_padded_conv", count)
    C.reset_launch_counts()
    with torch.no_grad():
        multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams), cfg)
    assert C.conv3d_fp32_cuda.launches == len(eligible) == forward_launches(3) == 116
    assert forward_launches(5) == 228 and forward_launches(8) == 396
    C.reset_launch_counts()


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU build)")
    return torch.device("cuda")


def _check_on_card(x, w, b, stride, pads):
    got = C.conv3d_fp32_cuda(x, w, b, stride, 1, pads)
    again = C.conv3d_fp32_cuda(x, w, b, stride, 1, pads)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == C.output_shape(x.shape, w.shape, stride, pads)
    assert torch.equal(got, again)
    scale = float(_exact(x, w, b, stride, pads, magnitude=True).max())
    err = float((got.double() - _exact(x, w, b, stride, pads)).abs().max())
    assert err <= KERNEL_BOUND(27 * x.shape[-1]) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + [e[0] for e in EDGES])
def test_kernel_against_exact(cuda, case):
    """The kernel against the float64 product within KERNEL_BOUND(K) of max sum |a||b|, on
    the path the plan names; two calls give the same bits."""
    x, w, b, stride, pads = _operands(case, device="cuda", seed=3)
    path = C.plan(x.shape[-1], w.shape[0], stride)["path"]
    before = C.conv3d_fp32_cuda.path_launches[path]
    _check_on_card(x, w, b, stride, pads)
    assert C.conv3d_fp32_cuda.path_launches[path] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(CONV3D_CLASSES)),
                         ids=[c[0] for c in CONV3D_CLASSES])
def test_kernel_full_size_classes(cuda, index):
    """Every class of the 5-view forward at its full size, 480x896 and D = 128."""
    _, (xs, ci, co, stride) = CONV3D_CLASSES[index]
    pads = S1 if stride == 1 else SAME_S2
    x, w, b, _, _ = _operands(("", xs + (ci,), co, stride, pads, False), device="cuda", seed=4)
    _check_on_card(x, w, b, stride, pads)


@pytest.mark.cuda
def test_kernel_misaligned_input_takes_the_scalar_path(cuda):
    x, w, b, stride, pads = _operands(CLASSES[0], device="cuda", seed=4)
    buf = torch.empty(x.numel() + 1, device="cuda")
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    before = C.conv3d_fp32_cuda.path_launches["scalar"]
    got = C.conv3d_fp32_cuda(shifted, w, b, stride, 1, pads)
    assert C.conv3d_fp32_cuda.path_launches["scalar"] == before + 1
    scale = float(_exact(x, w, b, stride, pads, magnitude=True).max())
    err = float((got.double() - _exact(x, w, b, stride, pads)).abs().max())
    assert err <= KERNEL_BOUND(27 * x.shape[-1]) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CLASSES[i] for i in (0, 1, 3)] + [EDGES[2], EDGES[3]],
                         ids=[IDS[i] for i in (0, 1, 3)] + [EDGES[2][0], EDGES[3][0]])
def test_kernel_gradients_are_pass_convs(cuda, case):
    """On the card the route's gradients are pass_conv's "highest" backward to the bit
    (deterministic cuDNN), the forward within the kernel's bound."""
    torch.backends.cudnn.deterministic = True
    try:
        x, w, b, stride, pads = _operands(case, device="cuda", seed=5)
        operands = (x, w) + (() if b is None else (b,))
        a = [t.clone().requires_grad_() for t in operands]
        t = [t.clone().requires_grad_() for t in operands]
        y = C.conv3d_fp32(a[0], a[1], a[2] if b is not None else None, stride, 1, pads)
        want = C.conv3d_fp32_torch(t[0], t[1], t[2] if b is not None else None, stride, 1, pads)
        g = torch.randn(y.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(6))
        y.backward(g)
        want.backward(g)
        for got_leaf, want_leaf in zip(a, t):
            assert torch.equal(got_leaf.grad, want_leaf.grad)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_served_forward_routes_every_highest_3d_conv(cuda):
    """One 5-view forward: every float32 3D conv in "highest" is a launch of the kernel
    (4 + 56 a pair)."""
    cfg = PipelineConfig(view_num=5, max_h=64, max_w=96, max_d=16)
    images, cams = synthetic_scene(view_num=5, H=64, W=96, D=16, seed=0)
    model = init_model(cfg, device="cuda")
    eligible = []
    real = L._padded_conv

    def count(x, w, b, stride, rate, pads, groups=1, precision="highest"):
        if x.dtype == torch.float32 and x.ndim == 5 and groups == 1 and precision == "highest":
            eligible.append(tuple(x.shape))
        return real(x, w, b, stride, rate, pads, groups, precision)

    C.reset_launch_counts()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(L, "_padded_conv", count)
        with torch.no_grad():
            multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams), cfg)
        torch.cuda.synchronize()
    assert C.conv3d_fp32_cuda.launches == len(eligible) == forward_launches(5) == 228
