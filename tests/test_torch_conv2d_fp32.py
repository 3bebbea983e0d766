"""ops.conv2d_fp32: the route of every float32 2D conv with groups 1 in "highest", its plain
version, its autograd Function and its launch counters on the CPU; the CUDA kernel on the
card (tests marked `cuda`, which skip at run time without one).

The plain version is the route's call before the kernel (pass_conv on the padded
channel-first view), so the CPU path computes what it did. Each class of the 5-view
forward's 2D convs (the FEM, the shallow FEM, CRM's and the refinement's D-constant halves)
appears below at a reduced size with its channels, kernel, stride, rate and pads. On the
card the kernel is held to the float64 product at each class within KERNEL_BOUND(K) of the
class's max sum |a||b| (conv_exact with magnitude=True), as the fp32-pass leaves are held:
run there with `python -m pytest --noconftest -q tests/test_torch_conv2d_fp32.py`.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import conv2d_forward_launches as forward_launches
from chip_smoke import conv2d_kernel_bound as KERNEL_BOUND
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import init_model
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import conv2d_fp32 as C
from atvsnet_torch.ops.fp32_passes import ConvSpec, conv_exact, pass_conv

S1, S2, S4 = ((1, 1), (1, 1)), ((2, 2), (2, 2)), ((4, 4), (4, 4))
SAME_S2 = ((0, 1), (0, 1))     # TF-SAME, k3 stride 2 on an even size
NONE = ((0, 0), (0, 0))

# (name, x (B, H, W, Ci), w (Co, Ci, kh, kw), stride, rate, pads, bias)
CLASSES = [
    ("FEM conv0_0 3->32 s2", (2, 16, 24, 3), (32, 3, 3, 3), 2, 1, SAME_S2, False),
    ("FEM conv0_1 32->32", (2, 8, 12, 32), (32, 32, 3, 3), 1, 1, S1, False),
    ("FEM unit 1x1 32->32", (2, 8, 12, 32), (32, 32, 1, 1), 1, 1, NONE, True),
    ("FEM unit 3x3 32->32", (2, 8, 12, 32), (32, 32, 3, 3), 1, 1, S1, True),
    ("FEM conv1 shortcut 1x1 32->64 s2", (2, 8, 12, 32), (64, 32, 1, 1), 2, 1, NONE, True),
    ("FEM conv1 1x1 32->64", (2, 8, 12, 32), (64, 32, 1, 1), 1, 1, NONE, True),
    ("FEM conv1 fixed-pad 3x3 64->64 s2", (2, 8, 12, 64), (64, 64, 3, 3), 2, 1, S1, True),
    ("FEM unit 1x1 64->64", (2, 4, 6, 64), (64, 64, 1, 1), 1, 1, NONE, True),
    ("FEM unit 3x3 64->64", (2, 4, 6, 64), (64, 64, 3, 3), 1, 1, S1, True),
    ("FEM conv2 1x1 64->128", (2, 4, 6, 64), (128, 64, 1, 1), 1, 1, NONE, True),
    ("FEM conv2 3x3 128->128 rate 2", (2, 5, 7, 128), (128, 128, 3, 3), 1, 2, S2, True),
    ("FEM unit 1x1 128->128", (2, 4, 6, 128), (128, 128, 1, 1), 1, 1, NONE, True),
    ("FEM conv3 3x3 128->128 rate 4", (2, 5, 9, 128), (128, 128, 3, 3), 1, 4, S4, True),
    ("FEM SPP 3x3 128->32 on 1x1", (2, 1, 1, 128), (32, 128, 3, 3), 1, 1, S1, False),
    ("FEM SPP 3x3 128->32 on 2x4", (2, 2, 4, 128), (32, 128, 3, 3), 1, 1, S1, False),
    ("FEM SPP 3x3 128->32 on 4x7", (2, 4, 7, 128), (32, 128, 3, 3), 1, 1, S1, False),
    ("FEM fusion0 3x3 320->128", (2, 4, 6, 320), (128, 320, 3, 3), 1, 1, S1, False),
    ("FEM fusion1 1x1 128->32", (2, 4, 6, 128), (32, 128, 1, 1), 1, 1, NONE, False),
    ("shallow shortcut 1x1 3->16 s4", (2, 16, 24, 3), (16, 3, 1, 1), 4, 1, NONE, True),
    ("shallow 1x1 3->16", (2, 16, 24, 3), (16, 3, 1, 1), 1, 1, NONE, True),
    ("shallow fixed-pad 3x3 16->16 s4", (2, 16, 24, 16), (16, 16, 3, 3), 4, 1, S1, True),
    ("shallow unit 3x3 16->16", (2, 4, 6, 16), (16, 16, 3, 3), 1, 1, S1, True),
    ("shallow feature 1x1 16->16", (2, 4, 6, 16), (16, 16, 1, 1), 1, 1, NONE, False),
    ("CRM 2D half 3x3 32->16 s2", (1, 8, 12, 32), (16, 32, 3, 3), 2, 1, SAME_S2, False),
    ("CRM / refine 2D half 3x3 32->8", (1, 4, 6, 32), (8, 32, 3, 3), 1, 1, S1, False),
    ("refine geo 2D half 3x3 2->8", (1, 4, 6, 2), (8, 2, 3, 3), 1, 1, S1, False),
]
IDS = [c[0] for c in CLASSES]
# past the forward's classes, for the kernel's edges: Co not a multiple of 4 (scalar
# stores, zero weight columns), Co over one tile (two tiles along N), Ci a multiple of 4
# but not of the 16 of a slice, M not a multiple of 128, a 1-pixel input at stride 2
EDGES = [
    ("Co 5", (1, 7, 9, 8), (5, 8, 3, 3), 1, 1, S1, True),
    ("Co 160, two tiles", (1, 6, 10, 32), (160, 32, 3, 3), 1, 1, S1, True),
    ("Ci 12, 5x5", (2, 9, 11, 12), (24, 12, 5, 5), 1, 1, S2, False),
    ("Ci 1 rate 3", (1, 13, 17, 1), (8, 1, 3, 3), 1, 3, ((3, 3), (3, 3)), False),
    ("1x1 input s2", (3, 1, 1, 64), (64, 64, 3, 3), 2, 1, S1, True),
]


def _operands(case, device="cpu", seed=0):
    _, xs, ws, stride, rate, pads, biased = case
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=device)
    w = torch.randn(ws, generator=g, device=device) / math.sqrt(math.prod(ws[1:]))
    b = torch.randn(ws[0], generator=g, device=device) if biased else None
    return x, w, b, stride, rate, pads


def _exact(x, w, b, stride, rate, pads, magnitude=False):
    """float64 conv_exact of the explicitly padded channel-first operands (+ the bias)."""
    xc = F.pad(x.movedim(-1, 1), [p for lo, hi in reversed(pads) for p in (lo, hi)])
    y = conv_exact(xc, w, ConvSpec.of(2, stride, 0, rate), magnitude=magnitude)["forward"]
    if b is not None:
        y = y + (b.abs() if magnitude else b).double()[:, None, None]
    return y.movedim(1, -1)


# ---- CPU ----

@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + [e[0] for e in EDGES])
def test_plain_and_gemm_against_pass_conv(case):
    """The plain version equals pass_conv on the explicitly padded operands; the kernel's GEMM
    (implicit_gemm_torch: its tap order and packed weights) in float64 equals the float64
    product; both at every class, TF-SAME's asymmetric pads, strides 2 and 4, rates 2 and 4,
    Ci = 3 and 2, the SPP maps down to 1x1."""
    x, w, b, stride, rate, pads = _operands(case)
    got = C.conv2d_fp32_torch(x, w, b, stride, rate, pads)
    xc = F.pad(x.movedim(-1, 1), [p for lo, hi in reversed(pads) for p in (lo, hi)])
    want = pass_conv(xc, w, "highest", stride, 0, rate, 1, b).movedim(1, -1)
    assert got.shape == C.output_shape(x.shape, w.shape, stride, rate, pads)
    exact = _exact(x, w, b, stride, rate, pads)
    scale = float(_exact(x, w, b, stride, rate, pads, magnitude=True).max())
    k = math.prod(w.shape[1:])
    assert float((got.double() - exact).abs().max()) <= KERNEL_BOUND(k) * scale
    assert float((want.double() - exact).abs().max()) <= KERNEL_BOUND(k) * scale
    gemm = C.implicit_gemm_torch(x.double(), w.double(), None if b is None else b.double(),
                                 stride, rate, pads)
    torch.testing.assert_close(gemm, exact, rtol=1e-12, atol=1e-12 * scale)


def test_plan_and_packed_weights():
    assert [C.plan(32, co)["tile"] for co in (5, 8, 16, 32, 33, 64, 65, 128, 320)] == \
        [32, 32, 32, 32, 64, 64, 128, 128, 128]
    assert [C.plan(ci, 32)["path"] for ci in (3, 2, 1, 4, 12, 32)] == \
        ["scalar"] * 3 + ["vector"] * 3
    assert C.plan(32, 32, aligned=False)["path"] == "scalar"
    w = torch.randn(6, 5, 3, 2)
    wp = C.packed_weights(w)
    assert wp.shape == (3 * 2 * 5, 8) and wp.is_contiguous()
    for i in range(3):
        for j in range(2):
            for c in range(5):
                assert torch.equal(wp[(i * 2 + j) * 5 + c, :6], w[:, c, i, j])
    assert not wp[:, 6:].any()


def _route_cases():
    x4 = torch.randn(1, 6, 8, 8)
    x5 = torch.randn(1, 4, 6, 8, 8)
    w2, w3 = torch.randn(8, 8, 3, 3), torch.randn(8, 8, 3, 3, 3)
    return [
        ("highest 2D conv", lambda: L.conv(x4, w2), 1),
        ("highest 2D conv with bias and relu", lambda: L.conv(x4, w2, torch.randn(8), relu=True), 1),
        ("fixed-pad strided 2D conv", lambda: L.fixed_pad_conv(x4, w2), 1),
        ("conv_bn 2D", lambda: L.conv_bn(x4, w2), 1),
        ("high 2D conv", lambda: L.conv(x4, w2, precision="high"), 0),
        ("default 2D conv", lambda: L.conv(x4, w2, precision="default"), 0),
        ("bf16 2D conv", lambda: L.conv(x4.bfloat16(), w2), 0),
        ("3D conv", lambda: L.conv(x5, w3), 0),
        ("3D deconv", lambda: L.deconv(x5, w3), 0),
        ("grouped depthwise then pointwise", lambda: L.split_separable_conv2d(
            x4, torch.randn(1, 8, 3, 3), torch.randn(8, 8, 1, 1)), 1),
        ("conv3d_mixed: its 2D halves", lambda: L.conv3d_mixed(
            torch.randn(8, 12, 3, 3, 3), x5, torch.randn(1, 6, 8, 4)), 3),
        ("conv3d_mixed in high", lambda: L.conv3d_mixed(
            torch.randn(8, 12, 3, 3, 3), x5, torch.randn(1, 6, 8, 4), precision="high"), 0),
    ]


@pytest.mark.parametrize("index", range(len(_route_cases())),
                         ids=[c[0] for c in _route_cases()])
def test_route(monkeypatch, index):
    """Which calls take ops.conv2d_fp32 (the kernel on CUDA): float32, 2D, groups 1 and
    "highest"; not "high", "default", bf16, grouped or 3D calls."""
    _, fn, expected = _route_cases()[index]
    calls = []

    def record(x, w, b, stride, rate, pads):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return C.conv2d_fp32(x, w, b, stride, rate, pads)

    monkeypatch.setattr(L, "conv2d_fp32", record)
    fn()
    assert len(calls) == expected


def test_cpu_calls_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the launcher: the route runs the plain version, the call
    it made before the kernel, to the bit."""
    def refuse(*args):
        raise AssertionError("the kernel's launcher ran for a CPU tensor")

    monkeypatch.setattr(C, "conv2d_fp32_cuda", refuse)
    x, w, b = torch.randn(2, 9, 11, 8), torch.randn(16, 8, 3, 3), torch.randn(16)
    pads = [L._same_pads(s, 3, 2) for s in x.shape[1:3]]
    got = L.conv(x, w, b, stride=2)
    assert torch.equal(got, C.conv2d_fp32_torch(x, w, b, 2, 1, pads))


@pytest.mark.parametrize("case", [CLASSES[i] for i in (0, 2, 6, 10, 16, 20, 23, 25)],
                         ids=[IDS[i] for i in (0, 2, 6, 10, 16, 20, 23, 25)])
def test_function_gradients_are_pass_convs(monkeypatch, case):
    """Conv2dFp32Function's gradients (input, weight, bias) equal the plain version's under
    autograd (pass_conv's "highest" backward through F.pad) to the bit; the launcher is
    stood in by the plain version on the CPU."""
    monkeypatch.setattr(C, "conv2d_fp32_cuda", C.conv2d_fp32_torch)
    x, w, b, stride, rate, pads = _operands(case, seed=1)
    operands = (x, w) + (() if b is None else (b,))
    leaves = [t.clone().requires_grad_() for t in operands]
    twins = [t.clone().requires_grad_() for t in operands]
    bias, bias_twin = (leaves[2], twins[2]) if b is not None else (None, None)
    y = C.Conv2dFp32Function.apply(leaves[0], leaves[1], bias, stride, rate, pads,
                                   C.conv2d_fp32_cuda)
    want = C.conv2d_fp32_torch(twins[0], twins[1], bias_twin, stride, rate, pads)
    assert torch.equal(y, want)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    y.backward(g)
    want.backward(g)
    for got_leaf, want_leaf in zip(leaves, twins):
        assert torch.equal(got_leaf.grad, want_leaf.grad)


def test_launch_counters(monkeypatch):
    """launches, path_launches and shape_launches (x shape, w shape, stride, rate, pads) count
    each launch; reset_launch_counts clears them. The launch itself is stood in here."""
    monkeypatch.setattr(C, "check_channel_last_cuda", lambda *a: None)
    monkeypatch.setattr(C, "_launch", lambda x, wp, bias, w_shape, stride, rate, pads, p:
                        torch.zeros(C.output_shape(x.shape, w_shape, stride, rate, pads)))
    C.reset_launch_counts()
    x8 = torch.randn(2, 6, 8, 8)
    x3 = torch.randn(2, 6, 8, 3)
    misaligned = torch.randn(2 * 6 * 8 * 8 + 1)[1:].view(2, 6, 8, 8)
    w8, w3 = torch.randn(16, 8, 3, 3), torch.randn(16, 3, 3, 3)
    for x, w in ((x8, w8), (x8, w8), (x3, w3), (misaligned, w8)):
        C.conv2d_fp32_cuda(x, w, None, 1, 1, S1)
    assert C.conv2d_fp32_cuda.launches == 4
    assert C.conv2d_fp32_cuda.path_launches == {"vector": 2, "scalar": 2}
    assert C.conv2d_fp32_cuda.shape_launches == {
        ((2, 6, 8, 8), (16, 8, 3, 3), 1, 1, S1): 3, ((2, 6, 8, 3), (16, 3, 3, 3), 1, 1, S1): 1}
    C.reset_launch_counts()
    assert C.conv2d_fp32_cuda.launches == 0 and C.conv2d_fp32_cuda.shape_launches == {}
    assert C.conv2d_fp32_cuda.path_launches == {"vector": 0, "scalar": 0}


def test_forward_launches_per_view_count(monkeypatch):
    """forward_launches(N): the 2D convs of one N-view forward that take the route (FEM 62,
    shallow FEM 11, 16 per pair), counted here at 3 views on the CPU."""
    cfg = PipelineConfig(view_num=3, max_h=32, max_w=64, max_d=8)
    images, cams = synthetic_scene(view_num=3, H=32, W=64, D=8, seed=0)
    model = init_model(cfg, device="cpu")
    calls = []
    monkeypatch.setattr(L, "conv2d_fp32", lambda *a: calls.append(1) or C.conv2d_fp32(*a))
    with torch.no_grad():
        multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams), cfg)
    assert len(calls) == forward_launches(3) == 105


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLASSES + EDGES, ids=IDS + [e[0] for e in EDGES])
def test_kernel_against_exact(cuda, case):
    """The kernel against the float64 product within KERNEL_BOUND(K) of max sum |a||b|, on
    the path the plan names; two calls give the same bits."""
    x, w, b, stride, rate, pads = _operands(case, device="cuda", seed=3)
    before = dict(C.conv2d_fp32_cuda.path_launches)
    got = C.conv2d_fp32_cuda(x, w, b, stride, rate, pads)
    again = C.conv2d_fp32_cuda(x, w, b, stride, rate, pads)
    torch.cuda.synchronize()
    path = C.plan(x.shape[-1], w.shape[0])["path"]
    assert C.conv2d_fp32_cuda.path_launches[path] == before[path] + 2
    assert got.is_contiguous() and got.shape == C.output_shape(x.shape, w.shape, stride, rate, pads)
    assert torch.equal(got, again)
    scale = float(_exact(x, w, b, stride, rate, pads, magnitude=True).max())
    err = float((got.double() - _exact(x, w, b, stride, rate, pads)).abs().max())
    assert err <= KERNEL_BOUND(math.prod(w.shape[1:])) * scale


@pytest.mark.cuda
def test_kernel_misaligned_input_takes_the_scalar_path(cuda):
    case = CLASSES[3]
    x, w, b, stride, rate, pads = _operands(case, device="cuda", seed=4)
    buf = torch.empty(x.numel() + 1, device="cuda")
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    before = C.conv2d_fp32_cuda.path_launches["scalar"]
    got = C.conv2d_fp32_cuda(shifted, w, b, stride, rate, pads)
    assert C.conv2d_fp32_cuda.path_launches["scalar"] == before + 1
    want = C.conv2d_fp32_cuda(x, w, b, stride, rate, pads)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CLASSES[i] for i in (0, 6, 10, 23)],
                         ids=[IDS[i] for i in (0, 6, 10, 23)])
def test_kernel_gradients_are_pass_convs(cuda, case):
    """On the card the route's gradients are pass_conv's "highest" backward to the bit
    (deterministic cuDNN), the forward within the kernel's bound."""
    torch.backends.cudnn.deterministic = True
    try:
        x, w, b, stride, rate, pads = _operands(case, device="cuda", seed=5)
        a = [t.clone().requires_grad_() for t in (x, w)]
        t = [t.clone().requires_grad_() for t in (x, w)]
        y = C.conv2d_fp32(a[0], a[1], b, stride, rate, pads)
        want = C.conv2d_fp32_torch(t[0], t[1], b, stride, rate, pads)
        g = torch.randn(y.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(6))
        y.backward(g)
        want.backward(g)
        assert torch.equal(a[0].grad, t[0].grad) and torch.equal(a[1].grad, t[1].grad)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_served_forward_routes_every_highest_2d_conv(cuda):
    """One 5-view forward: every float32 2D conv with groups 1 in "highest" is a launch of the
    kernel (the FEM's 62, the shallow FEM's 11, 16 per pair)."""
    cfg = PipelineConfig(view_num=5, max_h=64, max_w=96, max_d=16)
    images, cams = synthetic_scene(view_num=5, H=64, W=96, D=16, seed=0)
    model = init_model(cfg, device="cuda")
    eligible = []
    real = L._padded_conv

    def count(x, w, b, stride, rate, pads, groups=1, precision="highest"):
        if x.dtype == torch.float32 and x.ndim == 4 and groups == 1 and precision == "highest":
            eligible.append(tuple(x.shape))
        return real(x, w, b, stride, rate, pads, groups, precision)

    C.reset_launch_counts()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(L, "_padded_conv", count)
        with torch.no_grad():
            multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams), cfg)
        torch.cuda.synchronize()
    assert C.conv2d_fp32_cuda.launches == len(eligible) == forward_launches(5) == 137
