"""ops.plane_sweep: the route of every sample of geometry.warp (the plane sweeps, the 2D warps
by depth, the visual hull), its plan, its autograd Function and its launch counters on the
CPU; the CUDA kernel on the card (tests marked `cuda`, which skip at run time without one).

The plain version, ops.plane_sweep.sample_torch, is geometry.warp._sample as it was before
the kernel, so the CPU path computes what it did. On the card the kernel is held to the
plain version to the bit (outputs compared as integers of their width) at every class of
the forward at full size (480x896, D = 128: CRM's 32-channel sweeps, the refinement's
17-channel sweep with the nearest of its 17th channel and the mask, the 16- and 1-channel 2D
warps by depth, the hull's 1-channel nearest sweep), at B = 2, in float32 and bfloat16, on
edge coordinates, and its gradients against the plain version's: run there with
`python -m pytest --noconftest -q tests/test_torch_plane_sweep.py`.
"""

import math

import pytest
import torch

from chip_smoke import same_bits
from chip_smoke import sweep_forward_launches as forward_launches
from atvsnet_torch import geometry
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.geometry import visual_hull, warp
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import init_model
from atvsnet_torch.ops import plane_sweep as P


def sweep_coords(B, D, H, W, seed=0, device="cpu"):
    """Texture coordinates (B, D*H*W) of a plane sweep onto an H x W map: per plane a
    near-affine map (scale, shear, a shift that moves across the planes), so that samples
    fall inside, on the border and off the map, as a homography sweep's do."""
    g = torch.Generator().manual_seed(seed)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64) + 0.5,
                          torch.arange(W, dtype=torch.float64) + 0.5, indexing="ij")
    a = 1 + 0.06 * torch.randn(B, 1, 1, 1, generator=g, dtype=torch.float64)
    shear = 0.04 * torch.randn(B, 1, 1, 1, generator=g, dtype=torch.float64)
    t = torch.linspace(-0.15, 0.35, D, dtype=torch.float64)[None, :, None, None]
    x = a * u + shear * v + t * W + 0.3
    y = (2 - a) * v - shear * u + 0.1 * t * H - 0.2
    return (x.reshape(B, -1).float().to(device), y.reshape(B, -1).float().to(device))


def _image(shape, dtype=torch.float32, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


# ---- CPU ----

@pytest.mark.parametrize("channels", [1, 3, 16, 17, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plan(channels, dtype):
    """The path from C, dtype, alignment and the outputs asked for: the vector path where C
    (and the nearest slice's start and width) are multiples of 16 bytes of the dtype and the
    image is aligned, else the scalar path."""
    width = 4 if dtype == torch.float32 else 8
    fits = channels % width == 0
    p = P.plan(channels, dtype, True, None)
    assert p == {"kind": "bilinear", "path": "vector" if fits else "scalar"}
    assert P.plan(channels, dtype, True, None, aligned=False)["path"] == "scalar"
    assert P.plan(channels, dtype, False, (0, channels)) == {"kind": "nearest",
                                                             "path": p["path"]}
    assert P.plan(channels, dtype, True, (channels - 1, 1)) == {"kind": "bilinear_nearest",
                                                                "path": "scalar"}
    if channels >= 2 * width and fits:
        assert P.plan(channels, dtype, True, (width, width))["path"] == "vector"


def test_plan_of_the_forward_classes():
    """The forward's classes: CRM's 32 channels and the 16-channel 2D warp take the vector
    path in both dtypes; the refinement's 17-channel source and the 1-channel depths the
    scalar one; a slice with a step or no channel is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        assert P.plan(32, dtype, True, None)["path"] == "vector"
        assert P.plan(16, dtype, True, None)["path"] == "vector"
        assert P.plan(17, dtype, True, P.nearest_range(slice(16, 17), 17))["path"] == "scalar"
        assert P.plan(1, dtype, False, P.nearest_range(slice(None), 1))["path"] == "scalar"
    assert P.nearest_range(None, 5) is None
    assert P.nearest_range(slice(None), 5) == (0, 5)
    assert P.nearest_range(slice(16, 17), 17) == (16, 1)
    assert P.nearest_range(slice(-1, None), 17) == (16, 1)
    for bad in (slice(0, 4, 2), slice(3, 3)):
        with pytest.raises(ValueError):
            P.nearest_range(bad, 5)


def _callers():
    """(name, call, kinds of the samples it makes): every caller of warp._sample."""
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, 9, 12, 5, generator=g)
    hom = (torch.eye(3) + 0.02 * torch.randn(2, 4, 3, 3, generator=g))
    hom[..., 0, 2] += 1.3
    _, cams = synthetic_scene(view_num=3, H=16, W=24, D=4, seed=1)
    cams = torch.as_tensor(cams)
    depth = 2.0 + torch.rand(1, 16, 24, 1, generator=g)
    depths = 2.0 + torch.rand(1, 3, 16, 24, generator=g)
    rgb = torch.randn(1, 16, 24, 3, generator=g)
    ds, di = geometry.depth_range_from_cams(cams)
    return [
        ("plane_sweep_warp bilinear", lambda: warp.plane_sweep_warp(img, hom, output_mask=True),
         ["bilinear"]),
        ("plane_sweep_warp int8", lambda: warp.plane_sweep_warp(img, hom, quant="int8"),
         ["bilinear"]),
        ("plane_sweep_warp nearest", lambda: warp.plane_sweep_warp(img, hom, method="nearest"),
         ["nearest"]),
        ("plane_sweep_warp_with_nearest", lambda: warp.plane_sweep_warp_with_nearest(
            img, hom, nearest_slice=slice(4, 5)), ["bilinear_nearest"]),
        ("interpolate bilinear", lambda: warp.interpolate(img, *sweep_coords(2, 1, 9, 12),
                                                          output_mask=True), ["bilinear"]),
        ("interpolate nearest", lambda: warp.interpolate(img, *sweep_coords(2, 1, 9, 12),
                                                         method="nearest"), ["nearest"]),
        ("homography_warp", lambda: warp.homography_warp(img, hom[:, 0], output_mask=True),
         ["bilinear"]),
        ("warp_by_depth bilinear", lambda: warp.warp_by_depth(
            rgb, cams[:, 0], cams[:, 1], depth,
            output_mask=True), ["bilinear"]),
        ("warp_by_depth nearest", lambda: warp.warp_by_depth(
            depth, cams[:, 0], cams[:, 1], depth, method="nearest", output_mask=True),
         ["nearest"]),
        ("get_visual_hull", lambda: visual_hull.get_visual_hull(depths, cams, 4, ds, di),
         ["nearest", "nearest"]),
    ]


@pytest.mark.parametrize("index", range(len(_callers())), ids=[c[0] for c in _callers()])
def test_route_of_each_caller(monkeypatch, index):
    """Each caller samples through warp._sample with the outputs it needs; on CPU tensors it
    takes the plain version, never launches, and gives the plain version's bits (warp._sample
    as it was)."""
    name, call, kinds = _callers()[index]

    def refuse(*args, **kw):
        raise AssertionError("the kernel's launcher ran for a CPU tensor")

    monkeypatch.setattr(P, "plane_sweep_cuda", refuse)
    monkeypatch.setattr(P, "_launch", refuse)
    seen = []
    plain = P.sample_torch

    def record(image, x, y, bilinear=True, nearest_channels=None):
        kind = P.plan(image.shape[-1], image.dtype, bilinear,
                      P.nearest_range(nearest_channels, image.shape[-1]))["kind"]
        seen.append(kind)
        return plain(image, x, y, bilinear, nearest_channels)

    monkeypatch.setattr(P, "sample_torch", record)
    got = call()
    assert seen == kinds
    monkeypatch.setattr(warp, "_sample", plain)
    want = call()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _stand_in_launches(monkeypatch):
    """The launcher's checks and launch stood in by the plain version on the CPU."""
    def launch(image, x, y, bilinear, nearest, p):
        sl = None if nearest is None else slice(nearest[0], nearest[0] + nearest[1])
        return P.sample_torch(image, x, y, bilinear, sl)

    monkeypatch.setattr(P, "check_cuda", lambda *a: None)
    monkeypatch.setattr(P, "_launch", launch)


def test_launch_counters(monkeypatch):
    """launches, path_launches ("<kind>.<path>") and shape_launches (image shape, P, dtype,
    kind, nearest channels) count each launch; reset_launch_counts clears them."""
    _stand_in_launches(monkeypatch)
    P.reset_launch_counts()
    x, y = sweep_coords(1, 2, 6, 8)
    im32, im17 = _image((1, 6, 8, 32)), _image((1, 6, 8, 17))
    misaligned = torch.randn(im32.numel() + 1)[1:].view(im32.shape)
    P.plane_sweep_cuda(im32, x, y)
    P.plane_sweep_cuda(im32, x, y)
    P.plane_sweep_cuda(im17, x, y, True, slice(16, 17))
    P.plane_sweep_cuda(im17[..., 16:], x, y, False, slice(None))
    P.plane_sweep_cuda(misaligned, x, y)
    P.plane_sweep_cuda(im32.bfloat16(), x, y)
    fn = P.plane_sweep_cuda
    assert fn.launches == 6
    assert fn.path_launches == {"bilinear.vector": 3, "bilinear.scalar": 1,
                                "bilinear_nearest.vector": 0, "bilinear_nearest.scalar": 1,
                                "nearest.vector": 0, "nearest.scalar": 1}
    assert fn.shape_launches == {
        ((1, 6, 8, 32), 96, "float32", "bilinear", None): 3,
        ((1, 6, 8, 17), 96, "float32", "bilinear_nearest", (16, 1)): 1,
        ((1, 6, 8, 1), 96, "float32", "nearest", (0, 1)): 1,
        ((1, 6, 8, 32), 96, "bfloat16", "bilinear", None): 1}
    P.reset_launch_counts()
    assert fn.launches == 0 and fn.shape_launches == {}
    assert fn.path_launches == dict.fromkeys(P.PATHS, 0)


def test_launcher_refuses_what_it_does_not_take():
    """A CPU tensor, another dtype, mismatched shapes or no output asked for raise."""
    x, y = sweep_coords(1, 1, 4, 4)
    img = _image((1, 4, 4, 4))
    with pytest.raises(ValueError):
        P.plane_sweep_cuda(img, x, y)
    with pytest.raises(ValueError):
        P.check_cuda(img.double(), x, y)
    with pytest.raises(ValueError):
        P.check_cuda(img, x, y[:, :5])


@pytest.mark.parametrize("bilinear,nearest,channels", [
    (True, None, 4), (True, slice(4, 5), 5), (False, slice(None), 1), (True, slice(None), 3)],
    ids=["bilinear", "bilinear_nearest", "nearest", "bilinear and full nearest"])
@pytest.mark.parametrize("wrt", ["image", "x y", "all"])
def test_function_gradients_are_the_plain_vjp(monkeypatch, bilinear, nearest, channels, wrt):
    """PlaneSweepFunction's gradients with respect to the image, x and y (each when it
    requires one) equal autograd of the plain version to the bit; the forward is stood in
    by the plain version on the CPU. x and y carry gradients where a depth map feeds the
    coordinates (training's warps by depth)."""
    _stand_in_launches(monkeypatch)
    img = _image((2, 7, 9, channels), seed=5)
    x, y = sweep_coords(2, 3, 7, 9, seed=6)
    x = x + 0.37 * torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    needs = {"image": (True, False, False), "x y": (False, True, True), "all": (True,) * 3}[wrt]
    a = [t.clone().requires_grad_(n) for t, n in zip((img, x, y), needs)]
    b = [t.clone().requires_grad_(n) for t, n in zip((img, x, y), needs)]
    got = P.PlaneSweepFunction.apply(*a, bilinear, nearest, P.plane_sweep_cuda)
    want = P.sample_torch(*b, bilinear, nearest)
    assert not got[2].requires_grad
    g = torch.Generator().manual_seed(8)
    loss_a = loss_b = 0
    for o, w in zip(got[:2], want[:2]):
        if w is None:
            assert o is None
            continue
        assert torch.equal(o, w)
        weight = torch.randn(w.shape, generator=g)
        loss_a = loss_a + (o * weight).sum()
        loss_b = loss_b + (w * weight).sum()
    if not loss_b.requires_grad:      # a nearest sample alone: no gradient reaches x and y
        assert not loss_a.requires_grad
        return
    loss_a.backward()
    loss_b.backward()
    for u, v in zip(a, b):
        assert (u.grad is None) == (v.grad is None)
        if v.grad is not None:
            assert torch.equal(u.grad, v.grad)


def test_forward_launch_counter_per_view_count(monkeypatch):
    """Over one 3-view forward the launch counter equals the forward's samples (counted at
    warp._sample) and sweep_forward_launches(3): 5 a pair. The route sends each to the
    Function, whose launcher is stood in on the CPU."""
    cfg = PipelineConfig(view_num=3, max_h=32, max_w=64, max_d=8)
    images, cams = synthetic_scene(view_num=3, H=32, W=64, D=8, seed=0)
    model = init_model(cfg, device="cpu")
    _stand_in_launches(monkeypatch)
    calls = []

    def count(image, x, y, bilinear=True, nearest_channels=None):
        calls.append(tuple(image.shape))
        return P.PlaneSweepFunction.apply(image, x, y, bilinear, nearest_channels,
                                          P.plane_sweep_cuda)

    monkeypatch.setattr(warp, "_sample", count)
    P.reset_launch_counts()
    with torch.no_grad():
        multi_view_forward(model, torch.as_tensor(images), torch.as_tensor(cams), cfg)
    assert P.plane_sweep_cuda.launches == len(calls) == forward_launches(3) == 10
    assert forward_launches(5) == 20 and forward_launches(8) == 35
    assert {k: v for k, v in P.plane_sweep_cuda.path_launches.items() if v} == {
        "bilinear.vector": 6, "bilinear_nearest.scalar": 2, "nearest.scalar": 2}
    P.reset_launch_counts()


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU build)")
    return torch.device("cuda")


def _same_bits(got, want):
    assert all(a is None or a.dtype == b.dtype for a, b in zip(got, want))
    assert same_bits(got, want)


# (name, image (B, H, W, C), planes, bilinear, nearest slice): the forward's classes at full
# size (480x896 maps at a quarter: 120x224, D = 128), then B = 2
FULL = [
    ("CRM sweep 32", (1, 120, 224, 32), 128, True, None),
    ("refine sweep 17 + nearest 16:17", (1, 120, 224, 17), 128, True, slice(16, 17)),
    ("hull sweep nearest 1", (1, 120, 224, 1), 128, False, slice(None)),
    ("warp_by_depth 16", (1, 120, 224, 16), 1, True, None),
    ("warp_by_depth nearest 1", (1, 120, 224, 1), 1, False, slice(None)),
    ("pair_batch CRM sweep 32 B2", (2, 120, 224, 32), 128, True, None),
    ("refine sweep B2", (2, 120, 224, 17), 16, True, slice(16, 17)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FULL, ids=[c[0] for c in FULL])
def test_kernel_equals_plain_at_full_size(cuda, case, dtype):
    """Every class of the forward at full size equals the plain version to the bit, on the
    path the plan names, with the same bits on a second call."""
    _, shape, planes, bilinear, nearest = case
    B, H, W, C = shape
    img = _image(shape, dtype, seed=1, device="cuda")
    x, y = sweep_coords(B, planes, H, W, seed=2, device="cuda")
    p = P.plan(C, dtype, bilinear, P.nearest_range(nearest, C))
    key = f"{p['kind']}.{p['path']}"
    before = P.plane_sweep_cuda.path_launches[key]
    got = P.plane_sweep_cuda(img, x, y, bilinear, nearest)
    again = P.plane_sweep_cuda(img, x, y, bilinear, nearest)
    want = P.sample_torch(img, x, y, bilinear, nearest)
    torch.cuda.synchronize()
    assert P.plane_sweep_cuda.path_launches[key] == before + 2
    assert 0.05 < float(got[2].float().mean()) < 0.95     # samples both inside and off the map
    _same_bits(got, want)
    _same_bits(again, got)


def _edge_coords(H, W):
    """Coordinates at the edges of the valid window (texture coordinates, before the shift
    of 0.5): NaN, +-inf, exactly 0 and the last valid column and row, the first invalid
    ones, ulps on either side, half-integers (the nearest's ties, which round to even),
    negative zero, far off the map."""
    nf = math.nextafter
    xs = [float("nan"), float("inf"), -float("inf"), 0.5, W - 0.5, H - 0.5, W - 1.5,
          nf(W - 0.5, 0.0), nf(0.5, 0.0), nf(0.5, 10.0), 1.0, 2.0, 3.0, 4.0, W - 1.0, -0.0,
          0.0, -1e30, 1e30, 2.5, 1.5, 0.75, 7.25]
    pts = [(a, b) for a in xs for b in xs]
    x = torch.tensor([p[0] for p in pts], dtype=torch.float32)
    y = torch.tensor([p[1] for p in pts], dtype=torch.float32)
    return x[None], y[None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels,bilinear,nearest", [
    (32, True, None), (17, True, slice(16, 17)), (1, False, slice(None)), (16, True, None),
    (3, True, slice(None)), (8, True, slice(4, 8)), (1, True, None)],
    ids=["32", "17 + nearest", "1 nearest", "16", "3 + nearest", "8 + nearest 4:8", "1"])
def test_kernel_edge_coordinates(cuda, dtype, channels, bilinear, nearest):
    """Edge coordinates give the plain version's bits on every path, at B = 2 (the second
    batch element's invalid nearest samples read its own pixel (0, 0))."""
    H, W = 9, 13
    x, y = _edge_coords(H, W)
    x, y = torch.cat([x, x.flip(1)]).cuda(), torch.cat([y, y.flip(1)]).cuda()
    img = _image((2, H, W, channels), dtype, seed=3, device="cuda")
    got = P.plane_sweep_cuda(img, x, y, bilinear, nearest)
    want = P.sample_torch(img, x, y, bilinear, nearest)
    _same_bits(got, want)


@pytest.mark.cuda
def test_kernel_misaligned_image_takes_the_scalar_path(cuda):
    img = _image((1, 30, 40, 32), seed=4, device="cuda")
    buf = torch.empty(img.numel() + 1, device="cuda")
    shifted = buf[1:].view(img.shape)
    shifted.copy_(img)
    x, y = sweep_coords(1, 4, 30, 40, seed=5, device="cuda")
    before = P.plane_sweep_cuda.path_launches["bilinear.scalar"]
    got = P.plane_sweep_cuda(shifted, x, y)
    assert P.plane_sweep_cuda.path_launches["bilinear.scalar"] == before + 1
    _same_bits(got, P.sample_torch(img, x, y))


@pytest.mark.cuda
def test_kernel_non_finite_pixel_at_the_origin(cuda):
    """An invalid sample reads pixel (0, 0) with weight 0: an inf there makes NaN, as on
    aten; the bilinear output agrees in value and in where it is NaN."""
    img = _image((1, 9, 13, 4), seed=6, device="cuda")
    img[0, 0, 0, 1] = float("inf")
    x, y = _edge_coords(9, 13)
    x, y = x.cuda(), y.cuda()
    got = P.plane_sweep_cuda(img, x, y, True, slice(None))
    want = P.sample_torch(img, x, y, True, slice(None))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bilinear,nearest,channels", [
    (True, None, 16), (True, slice(16, 17), 17), (False, slice(None), 1)],
    ids=["bilinear 16", "bilinear_nearest 17", "nearest 1"])
def test_kernel_gradients_are_the_plain_paths(cuda, bilinear, nearest, channels):
    """On the card the route's gradients (image, x, y) equal autograd of the plain version
    to the bit, under deterministic algorithms (index_select's backward adds with atomics
    otherwise); the forward to the bit."""
    torch.use_deterministic_algorithms(True)
    try:
        img = _image((2, 30, 40, channels), seed=7, device="cuda")
        x, y = sweep_coords(2, 3, 30, 40, seed=8, device="cuda")
        a = [t.clone().requires_grad_() for t in (img, x, y)]
        b = [t.clone().requires_grad_() for t in (img, x, y)]
        got = warp._sample(*a, bilinear, nearest)
        want = P.sample_torch(*b, bilinear, nearest)
        _same_bits(got, want)
        g = torch.Generator(device="cuda").manual_seed(9)
        weights = [None if w is None else torch.randn(w.shape, generator=g, device="cuda")
                   for w in want[:2]]
        sum(((o * w_).sum() for o, w_ in zip(got[:2], weights) if w_ is not None)).backward()
        sum(((o * w_).sum() for o, w_ in zip(want[:2], weights) if w_ is not None)).backward()
        for u, v in zip(a, b):
            assert (u.grad is None) == (v.grad is None)
            if v.grad is not None:
                assert torch.equal(u.grad, v.grad)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_served_forward_launches(cuda):
    """A 5-view forward at a reduced size launches the kernel sweep_forward_launches(5) times,
    by path as the plan says, and equals the plain route's forward to the bit (the rest of
    the forward on the card in both, deterministic cuDNN)."""
    cfg = PipelineConfig(view_num=5, max_h=64, max_w=96, max_d=16)
    images, cams = synthetic_scene(view_num=5, H=64, W=96, D=16, seed=0)
    images, cams = torch.as_tensor(images).cuda(), torch.as_tensor(cams).cuda()
    model = init_model(cfg, device="cuda")
    torch.backends.cudnn.deterministic = True
    try:
        P.reset_launch_counts()
        with torch.no_grad():
            out = multi_view_forward(model, images, cams, cfg)
            assert P.plane_sweep_cuda.launches == forward_launches(5) == 20
            assert {k: v for k, v in P.plane_sweep_cuda.path_launches.items() if v} == {
                "bilinear.vector": 12, "bilinear_nearest.scalar": 4, "nearest.scalar": 4}
            real = warp._sample
            warp._sample = P.sample_torch
            try:
                plain = multi_view_forward(model, images, cams, cfg)
            finally:
                warp._sample = real
        for k in ("depth", "confidence", "depth_views"):
            if k in out:
                assert torch.equal(out[k], plain[k]), k
    finally:
        torch.backends.cudnn.deterministic = False
        P.reset_launch_counts()
