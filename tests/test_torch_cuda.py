"""CUDA-only tests of the port: the hand-written soft-argmin kernels (the forward with and
without its softmax statistics, the one gradient kernel behind both backward entry points,
the depth split's partial forward, its grid's edges and its grid query) on the card, the
forward, pair_batch, DepthEstimator and training paths that launch them, and the
consistency fusion. The int8 conv kernel of act_quant="int8mxu" against its plain version
to the bit, on each of its paths and at the edges of its ring, a plan the kernel refuses,
and the int8mxu forwards that launch it. PipelineConfig.fp32_precision's pass leaves
(ops.fp32_passes) on the TF32 tensor cores: each leaf kind against its float64 plain
version, "highest" equal to the TF32-off call to the bit, the flags restored after every
call and set by the mode inside the backward, and each mode's small forward against the CPU.

Marked `cuda`; each test decides at run time (in the `cuda` fixture) whether a card is
present and skips with a reason otherwise. Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_cuda.py -q`. chip_smoke.py repeats these checks at
the main path's full shapes.
"""

import os

import numpy as np
import pytest
import torch

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import render_multiplane_scene, synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import init_model
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import int8_conv as I
from atvsnet_torch.ops import softargmin as S
from atvsnet_torch.params import load_model

pytestmark = pytest.mark.cuda

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU build)")
    return torch.device("cuda")


def _inputs(shape, dtype, device):
    g = torch.Generator(device=device).manual_seed(0)
    cost = (torch.randn(shape, device=device, generator=g) * 3).to(dtype)
    ds = torch.rand(shape[0], device=device, generator=g) + 0.3
    di = torch.rand(shape[0], device=device, generator=g) * 0.1 + 0.01
    return cost, ds, di


def _launch_and_compare(cost, ds, di, path):
    """One launch on the expected path; values and NaN positions as the plain version's."""
    before, by_path = S.softargmin_cuda.launches, dict(S.softargmin_cuda.path_launches)
    got = S.softargmin_cuda(cost, ds, di)
    torch.cuda.synchronize()
    assert S.softargmin_cuda.launches == before + 1
    by_path[path] += 1
    assert S.softargmin_cuda.path_launches == by_path
    ref = S.softargmin_torch(cost, ds, di)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True)
    return got


@pytest.mark.parametrize("shape,dtype,path", [((2, 16, 8, 24), torch.float32, "aligned"),
                                              ((2, 16, 8, 4095), torch.float32, "aligned"),
                                              ((2, 16, 7, 4095), torch.float32, "scalar"),
                                              ((1, 32, 5, 7), torch.bfloat16, "scalar"),
                                              ((1, 12, 3, 33), torch.float32, "scalar"),
                                              ((2, 1, 6, 8), torch.float32, "aligned"),
                                              ((1, 12, 6, 40), torch.bfloat16, "aligned"),
                                              ((1, 130, 6, 40), torch.float32, "aligned"),
                                              ((1, 130, 6, 40), torch.bfloat16, "aligned"),
                                              ((3, 48, 10, 12), torch.float32, "aligned"),
                                              ((3, 48, 7, 9), torch.float32, "scalar")])
def test_kernel_matches_plain(cuda, shape, dtype, path):
    _launch_and_compare(*_inputs(shape, dtype, cuda), path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_pointer_takes_the_scalar_kernel(cuda, dtype):
    """A contiguous view one element into a buffer: not 16-byte aligned, still a kernel."""
    cost, ds, di = _inputs((1, 128, 24, 32), dtype, cuda)
    flat = torch.empty(cost.numel() + 1, device=cuda, dtype=dtype)
    view = flat[1:].view(cost.shape)
    view.copy_(cost)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert S.kernel_path(cost.data_ptr(), 24 * 32, dtype) == "aligned"
    got = _launch_and_compare(view, ds, di, "scalar")
    torch.testing.assert_close(got, _launch_and_compare(cost, ds, di, "aligned"),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,dtype,path", [((1, 128, 24, 32), torch.float32, "aligned"),
                                              ((1, 128, 24, 32), torch.bfloat16, "aligned"),
                                              ((2, 130, 3, 33), torch.float32, "scalar")])
@pytest.mark.parametrize("which", ["first8", "slice", "all_but_one", "all"])
def test_inf_planes(cuda, which, shape, dtype, path):
    """+inf cost in the kernel's first chunk, in the upper half of D (whole slices on both
    paths), in every plane but one (finite depth), and in every plane of pixel 0 (NaN there,
    as in the plain version)."""
    cost, ds, di = _inputs(shape, dtype, cuda)
    B, D = shape[:2]
    flat = cost.view(B, D, -1)
    if which == "first8":
        flat[:, :8, ::5] = torch.inf
    elif which == "slice":
        flat[:, D // 2:, ::5] = torch.inf
    elif which == "all_but_one":
        keep = flat[:, D // 3, ::5].clone()
        flat[:, :, ::5] = torch.inf
        flat[:, D // 3, ::5] = keep
    else:
        flat[:, :, 0] = torch.inf
    got = _launch_and_compare(cost, ds, di, path)
    nan = torch.isnan(got).view(B, -1)
    assert int(nan.sum()) == (B if which == "all" else 0)
    assert which != "all" or bool(nan[:, 0].all())


def test_kernel_rejects_what_it_cannot_take(cuda):
    cost = torch.randn(1, 8, 4, 6, device=cuda)
    ds, di = torch.ones(1, device=cuda), torch.ones(1, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        S.softargmin_cuda(cost.transpose(2, 3), ds, di)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        S.softargmin_cuda(cost.half(), ds, di)
    with pytest.raises(ValueError, match="depth_start"):
        S.softargmin_cuda(cost, ds.cpu(), di)


def test_forward_launches_the_kernel_and_matches_cpu(cuda):
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    images, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=7)
    S.reset_launch_counts()
    gpu = multi_view_forward(init_model(cfg, device=cuda), images, cams, cfg)
    # 2 per pair x 2 pairs + AAM1 + native final depth + one 32-row upsample tile, all with
    # 16-byte-aligned planes (8x8 and 8x32 fp32)
    assert S.softargmin_cuda.launches == 7
    assert S.softargmin_cuda.path_launches == {"aligned": 7, "scalar": 0}
    cpu = multi_view_forward(init_model(cfg, device="cpu"), images, cams, cfg)
    np.testing.assert_allclose(gpu["depth"].cpu().numpy(), cpu["depth"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_pair_batch_on_the_card(cuda):
    """pair_batch=True: one (2, D, h, w) launch per pair in stage 1 instead of two, and the
    sequential path's depths (deterministic cuDNN; atol 1e-4 in sweep units of order 1)."""
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    images, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=7)
    model = init_model(cfg, device=cuda)
    torch.backends.cudnn.deterministic = True
    try:
        sequential = multi_view_forward(model, images, cams, cfg)
        S.reset_launch_counts()
        batched = multi_view_forward(model, images, cams, cfg.replace(pair_batch=True))
    finally:
        torch.backends.cudnn.deterministic = False
    assert S.softargmin_cuda.shape_launches == {(2, 8, 8, 8): 2, (1, 8, 8, 8): 2, (1, 8, 32, 32): 1}
    for key in ("depth", "depth_up", "depth_agg_initial", "depth_views"):
        torch.testing.assert_close(batched[key], sequential[key], rtol=1e-4, atol=1e-4)


def test_depth_estimator_predict_on_the_card(cuda):
    """predict on uint8 frames: 2 pairs x 2 kernel launches (the confidence path is plain
    PyTorch), un-padded shapes, and the CPU estimator's depths (atol 1e-3 on metric depth
    in [1, 4]: cuDNN against oneDNN through a whole forward)."""
    from atvsnet_torch.serving import DepthEstimator

    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 255, size=(24, 28, 3)).astype(np.uint8) for _ in range(3)]
    cams = []
    for v in range(3):
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.eye(4)
        cam[0, :2, 3] = (0.02 * v, 0.011 * v)
        cam[1, :3, :3] = [[28, 0, 14], [0, 28, 12], [0, 0, 1]]
        cam[1, 3] = (1.0, 3.0 / 8, 8, 4.0)
        cams.append(cam)
    est = DepthEstimator(cfg, seed=0)
    assert est.device.type == "cuda"
    S.reset_launch_counts()
    out = est.predict(images, cams)
    assert S.softargmin_cuda.shape_launches == {(1, 8, 8, 8): 4}
    assert out["depth"].shape == (6, 7) and out["depth_up"].shape == (24, 28)
    assert out["confidence"].shape == (6, 7) and out["runtime_s"] > 0
    ref = DepthEstimator(cfg, seed=0, device="cpu").predict(images, cams)
    for key in ("depth", "depth_up"):
        assert np.isfinite(out[key]).all()
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("normals", [False, True])
def test_consistency_fusion_on_the_card(cuda, normals):
    """fuse_depth_maps on the card: filtered pixels in every view (their projections are
    NaN: a sample index made from one would trip a device-side assert), dense equals sparse
    exactly, and the card's cloud is the CPU's up to threshold flips."""
    from atvsnet_torch.data.synthetic import make_cam, render_multiplane_views
    from atvsnet_torch.fusion.consistency import fuse_depth_maps
    from atvsnet_torch.fusion.dmb import fake_normals

    r = render_multiplane_views(5, 60, 80, seed=3, spacing=0.05, rot_step=0.02, num_spheres=1)
    cams = np.stack([make_cam(r["K_full"], r["Rs"][v], r["ts"][v]) for v in range(5)])
    holes = np.random.RandomState(4).rand(*r["depths"].shape) < 0.2
    depths = np.where(holes, 0.0, r["depths"]).astype(np.float32)
    images = np.uint8(r["images"] * 255.0)
    kw = {}
    if normals:
        kw = dict(normals=np.stack([fake_normals(d) for d in depths]), normal_thresh_deg=30.0)
    dense = fuse_depth_maps(depths, images, cams, compact="never", **kw)
    sparse = fuse_depth_maps(depths, images, cams, compact="always", ref_chunk=2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(dense, sparse):
        np.testing.assert_array_equal(a, b)
    cpu = fuse_depth_maps(depths, images, cams, compact="never", device="cpu", **kw)
    assert dense[0].shape[0] > 5000
    assert abs(dense[0].shape[0] - cpu[0].shape[0]) <= 1e-3 * cpu[0].shape[0]


@pytest.mark.parametrize("shape,dtype,path", [((1, 128, 24, 32), torch.float32, "aligned"),
                                              ((1, 32, 32, 40), torch.bfloat16, "aligned"),
                                              ((2, 16, 7, 33), torch.float32, "scalar"),
                                              ((1, 32, 5, 7), torch.bfloat16, "scalar")])
@pytest.mark.parametrize("which", [None, "slice", "all"])
def test_forward_stats_match_plain(cuda, shape, dtype, path, which):
    """The forward kernel asked for its softmax statistics: the same depth, to the bit, as
    without them; the max of -cost to the bit and the sum at rtol 1e-5 against
    softargmin_partial_torch at offset 0 (an all-+inf pixel: -inf and 0)."""
    cost, ds, di = _inputs(shape, dtype, cuda)
    B, D = shape[:2]
    if which == "slice":
        cost.view(B, D, -1)[:, D // 2:, ::5] = torch.inf
    elif which == "all":
        cost.view(B, D, -1)[:, :, 0] = torch.inf
    depth = _launch_and_compare(cost, ds, di, path)
    by_path = dict(S.softargmin_cuda.path_launches)
    got, stats = S.softargmin_cuda(cost, ds, di, with_stats=True)
    torch.cuda.synchronize()
    by_path[path] += 1
    assert S.softargmin_cuda.path_launches == by_path
    torch.testing.assert_close(got, depth, rtol=0, atol=0, equal_nan=True)
    ref = S.softargmin_partial_torch(cost, ds, di, 0)
    assert stats.shape == (2, B, *shape[2:]) and torch.equal(stats[0], ref[0])
    torch.testing.assert_close(stats[1], ref[1], rtol=RTOL, atol=0)
    if which == "all":
        assert bool(torch.isneginf(stats[0].view(B, -1)[:, 0]).all())
        assert bool((stats[1].view(B, -1)[:, 0] == 0).all())


# The gradient kernel against the closed-form plain backward on the same inputs: fp32 at
# rtol 1e-5 (ex2.approx and the order of two products), plus an atol of 1e-6 of the largest
# gradient for values that the kernel's flush-to-zero exponent makes 0; bf16 within one
# bf16 ulp (both round the same fp32 formula, which may straddle a rounding boundary).
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _backward_inputs(shape, dtype, device, transform=None):
    """The kernel inputs, the plain forward's depth and statistics, a seeded gradient."""
    cost, ds, di = _inputs(shape, dtype, device)
    if transform is not None:
        B, D = shape[:2]
        flat = cost.view(B, D, -1)
        if transform == "first8":
            flat[:, :8, ::5] = torch.inf
        elif transform == "all":
            flat[:, :, 0] = torch.inf
    depth, stats = S.softargmin_torch(cost, ds, di, with_stats=True)
    g = torch.Generator(device=device).manual_seed(1)
    grad = torch.randn(depth.shape, device=device, generator=g)
    return cost, ds, di, stats, depth, grad


def _backward_and_compare(cost, ds, di, stats, depth, grad, path):
    before, by_path = S.softargmin_backward_cuda.launches, dict(S.softargmin_backward_cuda.path_launches)
    got = S.softargmin_backward_cuda(cost, ds, di, stats, depth, grad)
    torch.cuda.synchronize()
    assert S.softargmin_backward_cuda.launches == before + 1
    by_path[path] += 1
    assert S.softargmin_backward_cuda.path_launches == by_path
    assert got.dtype == cost.dtype and got.shape == cost.shape
    ref = S.softargmin_backward_torch(cost, ds, di, depth, grad)
    scale = float(ref.float().nan_to_num(0.0).abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=BWD_TOL[cost.dtype],
                               atol=1e-6 * scale, equal_nan=True)
    return got


@pytest.mark.parametrize("shape,dtype,path", [((1, 32, 32, 40), torch.float32, "aligned"),
                                              ((1, 32, 32, 40), torch.bfloat16, "aligned"),
                                              ((1, 128, 120, 224), torch.float32, "aligned"),
                                              ((2, 16, 7, 4095), torch.float32, "scalar"),
                                              ((1, 32, 5, 7), torch.bfloat16, "scalar"),
                                              ((2, 1, 6, 8), torch.float32, "aligned"),
                                              ((1, 130, 6, 40), torch.float32, "aligned"),
                                              ((1, 130, 6, 40), torch.bfloat16, "aligned"),
                                              ((3, 48, 7, 9), torch.float32, "scalar")])
def test_backward_kernel_matches_plain(cuda, shape, dtype, path):
    _backward_and_compare(*_backward_inputs(shape, dtype, cuda), path)


@pytest.mark.parametrize("shape,dtype", [((1, 130, 120, 224), torch.float32),
                                         ((1, 130, 120, 224), torch.bfloat16),
                                         ((2, 128, 120, 224), torch.float32),
                                         ((2, 32, 32, 40), torch.bfloat16),
                                         ((1, 32, 32, 40), torch.float32),
                                         ((1, 32, 32, 40), torch.bfloat16)])
def test_gradient_grid_cases(cuda, shape, dtype):
    """The gradient kernel's 2-D grid at D not a multiple of its chunk of planes, at B = 2
    and at the train shape (more than 20 blocks, as the two-pass kernel had): against the
    closed form."""
    tiles, chunks, planes = S.gradient_grid(shape, dtype, "aligned")
    assert chunks == -(-shape[1] // planes) and chunks <= shape[1]
    if shape[1] == 130:
        assert shape[1] % planes != 0
    if shape[2:] == (32, 40) and shape[0] == 1:
        assert tiles * chunks > 20
    _backward_and_compare(*_backward_inputs(shape, dtype, cuda), "aligned")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_and_split_entries_give_the_same_gradient(cuda, dtype):
    """Both backward entry points launch the one gradient kernel: on the same statistics
    the whole-volume entry and the split entry at offset 0 agree to the bit, and the split
    entry on a slice at its offset gives that slice of the whole volume's gradient."""
    cost, ds, di, stats, depth, grad = _backward_inputs((1, 128, 24, 32), dtype, cuda)
    whole = S.softargmin_backward_cuda(cost, ds, di, stats, depth, grad)
    at0 = S.softargmin_backward_stats_cuda(cost, ds, di, 0, stats, depth, grad)
    part = S.softargmin_backward_stats_cuda(cost[:, 48:].contiguous(), ds, di, 48, stats, depth,
                                            grad)
    torch.cuda.synchronize()
    assert torch.equal(whole, at0) and torch.equal(whole[:, 48:], part)


@pytest.mark.parametrize("transform,path", [("first8", "aligned"), ("all", "aligned")])
def test_backward_inf_planes(cuda, transform, path):
    """+inf planes get gradient 0; a pixel whose planes are all +inf gets NaN in every
    plane, as the plain version's softmax gives it."""
    inputs = _backward_inputs((1, 128, 24, 32), torch.float32, cuda, transform)
    got = _backward_and_compare(*inputs, path)
    cost = inputs[0]
    if transform == "first8":
        assert bool((got[torch.isinf(cost)] == 0).all()) and not bool(torch.isnan(got).any())
    else:
        assert bool(torch.isnan(got[:, :, 0, 0]).all())
        assert int(torch.isnan(got).sum()) == cost.shape[1]


def test_backward_misaligned_pointer_takes_the_scalar_kernel(cuda):
    cost, ds, di, stats, depth, grad = _backward_inputs((1, 128, 24, 32), torch.float32, cuda)
    flat = torch.empty(cost.numel() + 1, device=cuda)
    view = flat[1:].view(cost.shape)
    view.copy_(cost)
    got = _backward_and_compare(view, ds, di, stats, depth, grad, "scalar")
    torch.testing.assert_close(got, _backward_and_compare(cost, ds, di, stats, depth, grad,
                                                          "aligned"), rtol=1e-5, atol=1e-9)


def test_backward_rejects_what_it_cannot_take(cuda):
    cost, ds, di, stats, depth, grad = _backward_inputs((1, 8, 4, 6), torch.float32, cuda)
    with pytest.raises(ValueError, match="grad"):
        S.softargmin_backward_cuda(cost, ds, di, stats, depth, grad.double())
    with pytest.raises(ValueError, match="depth"):
        S.softargmin_backward_cuda(cost, ds, di, stats, depth.cpu(), grad)
    with pytest.raises(ValueError, match="stats"):
        S.softargmin_backward_cuda(cost, ds, di, stats[:1], depth, grad)


def test_autograd_routes_through_both_kernels(cuda):
    """Under grad, softargmin(impl="auto") on the card returns a tensor with a grad_fn whose
    backward launches the backward kernel; under no_grad it launches the forward alone.
    The gradient is autograd's of the plain version (atol 1e-5 of max|g| * max|sweep|:
    that formula subtracts two values of that size)."""
    cost, ds, di, _, _, grad = _backward_inputs((1, 32, 32, 40), torch.float32, cuda)
    S.reset_launch_counts()
    with torch.no_grad():
        S.softargmin(cost, 32, ds, di)
    assert (S.softargmin_cuda.launches, S.softargmin_backward_cuda.launches) == (1, 0)
    leaf = cost.clone().requires_grad_(True)
    depth = S.softargmin(leaf, 32, ds, di)
    assert depth.grad_fn is not None
    depth.backward(grad)
    assert (S.softargmin_cuda.launches, S.softargmin_backward_cuda.launches) == (2, 1)
    ref = cost.clone().requires_grad_(True)
    S.softargmin_torch(ref, ds, di).backward(grad)
    sweep_max = float(S.sweep(32, ds, di).abs().max())
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=1e-5,
                               atol=1e-5 * float(grad.abs().max()) * sweep_max)
    with pytest.raises(ValueError, match="cost only"):
        S.softargmin(cost.clone().requires_grad_(True), 32, ds.clone().requires_grad_(True), di)


@pytest.mark.parametrize("remat,conf,launches", [(False, 0.0, (4, 4)), (True, 0.0, (6, 4)),
                                                 (False, 0.5, (3, 3)), (True, 0.5, (5, 3))])
def test_training_loss_launches_and_matches_plain(cuda, remat, conf, launches):
    """One training loss and backward at 3 views, 32x32, D=8 through the kernels: per pair
    one stage-1 soft-argmin, AAM1's, and the final depth's unless the confidence term sends
    it to the plain formula; remat recomputes stage 1 in the backward. Loss and gradients
    as impl="torch" under deterministic cuDNN (rtol 1e-4; the global gradient within 1e-3)."""
    from atvsnet_torch.config import TrainConfig
    from atvsnet_torch.data.synthetic import render_multiplane_scene
    from atvsnet_torch.models.train import loss_and_grads

    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32, remat=remat)
    tcfg = TrainConfig(loss_weight_confidence=conf)
    scene = render_multiplane_scene(view_num=3, H=32, W=32, D=8, seed=3, num_spheres=2)
    model = init_model(cfg, device=cuda).requires_grad_(True)
    torch.backends.cudnn.deterministic = True
    try:
        S.reset_launch_counts()
        loss, _, grads = loss_and_grads(model, scene, cfg, tcfg)
        torch.cuda.synchronize()
        assert (S.softargmin_cuda.launches, S.softargmin_backward_cuda.launches) == launches
        assert S.softargmin_cuda.shape_launches == {(1, 8, 8, 8): launches[0]}
        ref_loss, _, ref = loss_and_grads(model, scene, cfg.replace(softargmin_impl="torch"), tcfg)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=0)
    num = sum(float((grads[n] - ref[n]).square().sum()) for n in ref)
    den = sum(float(ref[n].square().sum()) for n in ref)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert (num / den) ** 0.5 < 1e-3


# ---- the depth-split entry points: the partial forward and the stats-fed backward ----

def _split_of(depth_num, rank=0, size=1):
    """A DepthSplit with no group: the merge and the backward's sum over one rank."""
    from atvsnet_torch.parallel.depth import DepthSplit
    return DepthSplit(None, rank, size, depth_num)


@pytest.mark.parametrize("shape,dtype,path,offset", [((1, 64, 24, 32), torch.float32, "aligned", 64),
                                                     ((1, 64, 24, 32), torch.bfloat16, "aligned", 0),
                                                     ((2, 16, 7, 33), torch.float32, "scalar", 16),
                                                     ((1, 12, 5, 7), torch.bfloat16, "scalar", 3),
                                                     ((1, 64, 3, 33), torch.float32, "scalar", 64),
                                                     ((1, 64, 3, 33), torch.bfloat16, "scalar", 0)])
def test_partial_kernel_matches_plain(cuda, shape, dtype, path, offset):
    cost, ds, di = _inputs(shape, dtype, cuda)
    cost.view(shape[0], shape[1], -1)[:, :, ::5] = torch.inf      # all-+inf pixels: (-inf, 0, 0)
    by_path = dict(S.softargmin_partial_cuda.path_launches)
    got = S.softargmin_partial_cuda(cost, ds, di, offset)
    torch.cuda.synchronize()
    by_path[path] += 1
    assert S.softargmin_partial_cuda.path_launches == by_path
    ref = S.softargmin_partial_torch(cost, ds, di, offset)
    assert torch.equal(got[0], ref[0])                              # the max is exact
    torch.testing.assert_close(got[1:], ref[1:], rtol=RTOL, atol=ATOL)
    assert bool(torch.isneginf(got[0]).view(shape[0], -1)[:, ::5].all())


@pytest.mark.parametrize("shape,dtype,offset,edge", [
    ((2, 16, 32, 40), torch.float32, 16, "no cluster"),      # the depth phase's train slice
    ((2, 16, 32, 40), torch.bfloat16, 16, "no cluster"),
    ((2, 128, 30, 36), torch.float32, 0, "cluster, tile cut"),  # B = 2, h*w no multiple of the tile
    ((2, 128, 30, 36), torch.bfloat16, 0, "cluster, tile cut"),
    ((1, 256, 8, 16), torch.float32, 0, "cluster of 8"),
    ((1, 65, 24, 32), torch.float32, 65, "chunks do not divide D")])
def test_partial_kernel_at_its_grid_edges(cuda, shape, dtype, offset, edge):
    """The partial kernel where its grid has edges: the train slice, whose warps hold one
    batch of planes each and so no cluster; clusters of several chunks, with a tile that
    spans two samples and one that is cut, and of the portable 8; a D_local that the
    chunks do not divide. The max to the bit and the sums at rtol 1e-5 against the plain
    partial forward and against the mirror of the kernel's arithmetic on the same grid."""
    tiles, chunks, cluster, warps, batch = S.partial_grid(shape, dtype, "aligned")
    tile_pixels = 32 * S.packet_pixels(dtype, "aligned")
    assert {"no cluster": cluster == 1,
            "cluster, tile cut": cluster > 1 and shape[0] == 2
            and shape[2] * shape[3] % tile_pixels != 0,
            "cluster of 8": cluster == 8,
            "chunks do not divide D": cluster > 1 and shape[1] % chunks != 0}[edge]
    cost, ds, di = _inputs(shape, dtype, cuda)
    got = S.softargmin_partial_cuda(cost, ds, di, offset)
    torch.cuda.synchronize()
    ref = S.softargmin_partial_torch(cost, ds, di, offset)
    mirror = S.softargmin_partial_split_torch(cost, ds, di, offset, chunks, warps, batch)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[0], mirror[0])
    torch.testing.assert_close(got[1:], ref[1:], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1:], mirror[1:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_grid_at_the_flagship_slice(cuda, dtype):
    """The grid query at a depth=2 rank's native slice: every number positive, the tiles
    cover the pixels, one cluster is the chunks of a tile (at most the portable 8), and
    every warp of every chunk has a plane of D."""
    shape = (1, 64, 120, 224)
    grid = S.partial_grid(shape, dtype, "aligned")
    print(f"partial grid at {shape} {dtype}: {grid}")
    tiles, chunks, cluster, warps, batch = grid
    assert min(grid) > 0
    assert tiles * 32 * S.packet_pixels(dtype, "aligned") >= shape[2] * shape[3]
    assert cluster == chunks <= 8 and chunks * warps <= shape[1]


@pytest.mark.parametrize("shape,dtype,path,offset", [((1, 64, 24, 32), torch.float32, "aligned", 64),
                                                     ((1, 64, 24, 32), torch.bfloat16, "aligned", 0),
                                                     ((2, 16, 7, 33), torch.float32, "scalar", 16)])
def test_backward_stats_kernel_matches_plain(cuda, shape, dtype, path, offset):
    cost, ds, di = _inputs(shape, dtype, cuda)
    depth, stats = S.merge_partials(S.softargmin_partial_torch(cost, ds, di, offset), None)
    g = torch.randn(depth.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    by_path = dict(S.softargmin_backward_stats_cuda.path_launches)
    got = S.softargmin_backward_stats_cuda(cost, ds, di, offset, stats, depth, g)
    torch.cuda.synchronize()
    by_path[path] += 1
    assert S.softargmin_backward_stats_cuda.path_launches == by_path
    ref = S.softargmin_backward_stats_torch(cost, ds, di, offset, stats, depth, g)
    rtol = RTOL if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=1e-6 * float(ref.float().abs().max()))


def test_split_function_routes_through_both_kernels(cuda):
    """SplitSoftArgminFunction on one rank: the partial and stats-fed kernels give the
    whole-D soft-argmin and autograd of softargmin_torch."""
    cost, ds, di = _inputs((1, 32, 32, 40), torch.float32, cuda)
    leaf = cost.clone().requires_grad_(True)
    before = (S.softargmin_partial_cuda.launches, S.softargmin_backward_stats_cuda.launches)
    depth = S.softargmin(leaf, 32, ds, di, impl="cuda", split=_split_of(32))
    g = torch.randn(depth.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    depth.backward(g)
    torch.cuda.synchronize()
    assert (S.softargmin_partial_cuda.launches, S.softargmin_backward_stats_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    ref_leaf = cost.clone().requires_grad_(True)
    ref = S.softargmin_torch(ref_leaf, ds, di)
    ref.backward(g)
    torch.testing.assert_close(depth, ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(leaf.grad, ref_leaf.grad, rtol=1e-5,
                               atol=1e-5 * float(g.abs().max()) * float(S.sweep(32, ds, di).abs().max()))


def test_split_entry_points_reject_what_they_cannot_take(cuda):
    cost, ds, di = _inputs((1, 8, 4, 8), torch.float32, cuda)
    with pytest.raises(ValueError):
        S.softargmin_partial_cuda(cost.cpu(), ds, di, 0)
    depth, stats = S.merge_partials(S.softargmin_partial_torch(cost, ds, di), None)
    with pytest.raises(ValueError):
        S.softargmin_backward_stats_cuda(cost, ds, di, 0, stats[:1], depth, depth)


@pytest.mark.parametrize("shape,co,stride,pads", [
    ((1, 16, 30, 56, 8), 8, 1, [(1, 1), (1, 1), (1, 1)]),
    ((1, 16, 30, 56, 8), 16, 2, [(0, 1), (0, 1), (0, 1)]),
    ((2, 9, 7, 13, 16), 32, 1, [(1, 1), (1, 1), (1, 1)]),
    ((1, 8, 15, 28, 64), 64, 1, [(1, 1), (1, 1), (1, 1)]),
    ((1, 16, 30, 56, 32), 64, 2, [(0, 1), (0, 1), (0, 1)]),
    ((4, 6, 5, 7, 8), 1, 1, [(1, 1), (1, 1), (1, 1)]),
    ((1, 6, 5, 7, 6), 3, 1, [(0, 0), (1, 1), (1, 1)])])
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_int8_conv_kernel_equals_plain(cuda, shape, co, stride, pads, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    xq = torch.randint(-127, 128, shape, device=cuda, dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (co, shape[-1], 3, 3, 3), device=cuda, dtype=torch.int8,
                       generator=g)
    scale = None if out_dtype is None else torch.tensor(1.3e-4, device=cuda)
    before = I.conv3d_int8_cuda.launches
    got = I.conv3d_int8(xq, wq, stride, pads, scale, out_dtype)
    torch.cuda.synchronize()
    assert I.conv3d_int8_cuda.launches == before + 1
    assert torch.equal(got, I.conv3d_int8_torch(xq, wq, stride, pads, scale, out_dtype))


def test_int8_conv_kernel_refuses_what_it_cannot_take(cuda):
    xq = torch.zeros((1, 4, 4, 4, 8), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):
        I.conv3d_int8_cuda(xq, torch.zeros((72, 8, 3, 3, 3), device=cuda, dtype=torch.int8), 1,
                           [(1, 1)] * 3)
    with pytest.raises(ValueError):
        I.conv3d_int8_cuda(xq[:, :, :, ::2], torch.zeros((8, 8, 3, 3, 3), device=cuda,
                                                         dtype=torch.int8), 1, [(1, 1)] * 3)


RING_EDGES = [  # (input, Co, stride, halo, what it exercises)
    ((1, 1, 12, 16, 8), 8, 1, False),       # Do = 1
    ((1, 3, 12, 16, 16), 16, 1, False),     # D shorter than the ring
    ((1, 9, 12, 16, 8), 16, 2, False),      # odd D at stride 2
    ((1, 45, 16, 32, 8), 8, 1, False),      # D chunk boundaries (asserted below)
    ((1, 10, 16, 32, 16), 32, 1, True),     # a depth block with its halo, D pads (0, 0)
    ((1, 9, 16, 32, 16), 16, 2, True),
    ((1, 4, 9, 20, 8), 8, 1, False),        # ragged last tiles along W and H
    ((1, 3, 5, 4, 8), 8, 1, False),         # a merged row narrower than the box
    ((1, 4, 16, 20, 32), 16, 1, False),     # Ci 32 on the 5-D map
    ((1, 4, 8, 16, 64), 64, 1, False),      # Ci 64, Co 64
    ((2, 5, 8, 12, 16), 1, 1, False),       # Co 1, B = 2
]


@pytest.mark.parametrize("path", ["ring", "ring_cluster"])
@pytest.mark.parametrize("shape,co,stride,halo", RING_EDGES)
def test_int8_ring_paths_at_their_edges(cuda, shape, co, stride, halo, path):
    """Each ring path, forced, equal to the plain version to the bit in int32, fp32 and
    bf16 out, at the edges of its ring, chunks and tensor maps."""
    g = torch.Generator(device=cuda).manual_seed(5)
    xq = torch.randint(-127, 128, shape, device=cuda, dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (co, shape[-1], 3, 3, 3), device=cuda, dtype=torch.int8,
                       generator=g)
    pads = [(0, 0) if halo and i == 0 else L._same_pads(n, 3, stride)
            for i, n in enumerate(shape[1:4])]
    p = I.launch_plan(shape, co, stride, pads, path=path)
    if shape == (1, 45, 16, 32, 8):
        assert p["chunks"] > 1
    scale = torch.tensor(1.3e-4, device=cuda)
    for out_dtype in (None, torch.float32, torch.bfloat16):
        sc = None if out_dtype is None else scale
        before = I.conv3d_int8_cuda.path_launches[path]
        got = I.launch(xq, wq, stride, pads, sc, out_dtype, p)
        torch.cuda.synchronize()
        assert I.conv3d_int8_cuda.path_launches[path] == before + 1
        assert torch.equal(got, I.conv3d_int8_torch(xq, wq, stride, pads, sc, out_dtype))


def test_int8_plan_the_kernel_refuses_raises(cuda):
    """No fallback: a plan that the C side does not take raises in the wrapper."""
    xq = torch.zeros((1, 4, 8, 16, 8), device=cuda, dtype=torch.int8)
    wq = torch.zeros((8, 8, 3, 3, 3), device=cuda, dtype=torch.int8)
    pads = [(1, 1)] * 3
    p = I.plan(xq.shape, 8, 1, pads, path="ring")
    before = I.conv3d_int8_cuda.launches
    for bad in (dict(smem_bytes=p["smem_bytes"] + 16), dict(ring=2), dict(chunks=p["chunks"] + 1),
                dict(tile_w=p["tile_w"] * 2), dict(cluster=3), dict(blocks_per_sm=64)):
        with pytest.raises(RuntimeError):
            I.launch(xq, wq, 1, pads, None, None, dict(p, **bad))
    x6 = torch.zeros((1, 4, 8, 16, 6), device=cuda, dtype=torch.int8)
    with pytest.raises(RuntimeError):   # no tensor map describes Ci 6
        I.launch(x6, torch.zeros((8, 6, 3, 3, 3), device=cuda, dtype=torch.int8), 1, pads,
                 None, None, p)
    assert I.conv3d_int8_cuda.launches == before


def test_int8mxu_flagship_forward_runs_on_the_ring_paths(cuda):
    """The flagship forward's 196 int8 launches by shape, all on the ring paths."""
    from chip_smoke import INT8_MAIN_SHAPES, int8_pads
    cfg = PipelineConfig(act_quant="int8mxu")
    images, cams = synthetic_scene(view_num=cfg.view_num, H=cfg.max_h, W=cfg.max_w,
                                   D=cfg.max_d, seed=0)
    model = load_model(SPHERES, cfg, device="cuda")
    I.reset_launch_counts()
    with torch.no_grad():
        multi_view_forward(model, images, cams, cfg)
    torch.cuda.synchronize()
    assert I.conv3d_int8_cuda.shape_launches == INT8_MAIN_SHAPES
    paths = I.conv3d_int8_cuda.path_launches
    assert paths["generic"] == 0 and paths["ring"] + paths["ring_cluster"] == 196
    for key, n in INT8_MAIN_SHAPES.items():
        assert I.plan(key[:5], key[5], key[6], int8_pads(key[:5], key[6]))["path"] != "generic"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8mxu_forward_launches_the_int8_kernel(cuda, dtype):
    """Every qin conv of the small forward on the kernel: per CRM pass 20 (19 trunk convs
    and the prob conv), per refinement 8, per AAM 2; and the card against the CPU."""
    cfg = PipelineConfig(view_num=3, max_d=32, max_h=64, max_w=96, compute_dtype=dtype,
                         act_quant="int8mxu")
    scene = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
    I.reset_launch_counts()
    got = multi_view_forward(load_model(SPHERES, cfg, device="cuda"), scene["images"],
                             scene["cams"], cfg)
    torch.cuda.synchronize()
    assert I.conv3d_int8_cuda.launches == 2 * 2 * 20 + 2 * 8 + 2 * 2
    want = multi_view_forward(load_model(SPHERES, cfg, device="cpu"), scene["images"],
                              scene["cams"], cfg)
    # the bounds of tests/test_torch_int8_conv.py against JAX: the chaos of lattice ties
    mean_bound, max_bound = {"float32": (2e-3, 1e-2), "bfloat16": (6e-3, 4.5e-2)}[dtype]
    for k in ("depth", "depth_agg_initial", "depth_views"):
        d = (got[k].float().cpu() - want[k].float()).abs()
        assert torch.isfinite(got[k]).all()
        assert float(d.mean()) <= mean_bound and float(d.max()) <= max_bound, (k, d.max())
    assert L.ActQuant.of(cfg).mode == "int8mxu"


# ---- fp32_precision (ops.fp32_passes) on the TF32 tensor cores ----

PASS_CASES = [  # (name, x channel-last, w, ConvSpec args or None for a matmul)
    ("conv2d s2", (2, 40, 48, 8), (16, 8, 3, 3), dict(nd=2, stride=2, padding=1)),
    ("conv2d rate 2", (2, 30, 34, 32), (32, 32, 3, 3), dict(nd=2, padding=2, dilation=2)),
    ("conv3d", (1, 16, 20, 24, 8), (16, 8, 3, 3, 3), dict(nd=3, padding=1)),
    ("conv3d s2", (1, 16, 20, 24, 8), (16, 8, 3, 3, 3), dict(nd=3, stride=2, padding=1)),
    ("transposed 3d", (1, 8, 10, 12, 16), (16, 8, 3, 3, 3), dict(nd=3, stride=2, transposed=True)),
    ("depthwise", (2, 30, 34, 32), (32, 1, 3, 3), dict(nd=2, padding=1, groups=32)),
    ("matmul", (4, 30, 34, 64), (64, 24), None),
]


def _pass_leaf(mode, x, w, spec, g=None):
    from atvsnet_torch.ops import fp32_passes as P
    xr, wr = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    if spec is None:
        y = P.pass_matmul(xr, wr, mode)
    elif spec.transposed:
        y = P.pass_conv_transpose(xr, wr, mode, spec.stride)
    else:
        y = P.pass_conv(xr, wr, mode, spec.stride, spec.padding, spec.dilation, spec.groups)
    if g is None:
        g = torch.randn(y.shape, device=y.device, generator=torch.Generator(y.device).manual_seed(1))
    y.backward(g)
    return {"forward": y.detach(), "grad_input": xr.grad, "grad_weight": wr.grad}, g


def _pass_case(case, device):
    from atvsnet_torch.ops import fp32_passes as P
    _, xs, ws, spec_kw = case
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(xs, device=device, generator=gen)
    if spec_kw is not None:
        x = x.movedim(-1, 1)
    w = torch.randn(ws, device=device, generator=gen) * 0.2
    return x, w, None if spec_kw is None else P.ConvSpec.of(**spec_kw)


@pytest.mark.parametrize("case", PASS_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("mode", ["high", "default"])
def test_pass_leaf_matches_its_float64_plain_version(cuda, mode, case):
    """Forward, grad_input and grad_weight on the TF32 tensor cores against the float64
    plain version within max(2^-20, 4 e) of max sum |a||b|, e the "highest" call's own error
    against the exact product; plain TF32 misses that bound (the mode is not TF32)."""
    from atvsnet_torch.ops import fp32_passes as P
    torch.backends.cudnn.deterministic = True
    try:
        x, w, spec = _pass_case(case, cuda)
        got, g = _pass_leaf(mode, x, w, spec)
        top, _ = _pass_leaf("highest", x, w, spec, g)
        if spec is None:
            plain, ex, mag = (P.matmul_plain(x, w, mode, g), P.matmul_exact(x, w, g),
                              P.matmul_exact(x, w, g, True))
            with P.tf32(True):
                tf = {"forward": x @ w, "grad_input": g @ w.T,
                      "grad_weight": x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])}
        else:
            plain, ex, mag = (P.conv_plain(x, w, mode, spec, g), P.conv_exact(x, w, spec, g),
                              P.conv_exact(x, w, spec, g, True))
            with P.tf32(True):
                tf = {"forward": spec.forward(x, w), "grad_input": spec.grad_input(x, g, w),
                      "grad_weight": spec.grad_weight(x, g, w)}
    finally:
        torch.backends.cudnn.deterministic = False
    for k in got:
        s = float(mag[k].max())
        e = float((top[k].double() - ex[k]).abs().max()) / s
        bound = max(2.0 ** -20, 4 * e)
        err = float((got[k].double() - plain[k]).abs().max()) / s
        assert err <= bound, (k, err, bound)
        if k != "grad_weight":    # a long sum averages TF32's operand errors out
            assert float((tf[k].double() - plain[k]).abs().max()) / s > bound, k


@pytest.mark.parametrize("case", PASS_CASES, ids=lambda c: c[0])
def test_highest_leaf_is_the_tf32_off_call_to_the_bit(cuda, case):
    from atvsnet_torch.ops import fp32_passes as P
    torch.backends.cudnn.deterministic = True
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        x, w, spec = _pass_case(case, cuda)
        got, g = _pass_leaf("highest", x, w, spec)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        if spec is None:
            want = {"forward": x @ w, "grad_input": g @ w.T,
                    "grad_weight": x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])}
        else:
            gx, gw, _ = spec.backward(x, g, w, [True, True, False])
            want = {"forward": spec.forward(x, w), "grad_input": gx, "grad_weight": gw}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
        torch.backends.cudnn.deterministic = False
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)])
def test_pass_calls_restore_the_tf32_flags_and_scope_the_backward(cuda, flags, monkeypatch):
    """Every call, forward and backward, leaves both flags as it found them; inside, the
    backward's ops see the mode's own setting, whatever the caller's flags say."""
    from atvsnet_torch.ops import fp32_passes as P
    seen = []
    for name in ("backward", "grad_input", "grad_weight"):
        orig = getattr(P.ConvSpec, name)

        def spy(self, *args, _orig=orig):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return _orig(self, *args)
        monkeypatch.setattr(P.ConvSpec, name, spy)
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    try:
        for case in PASS_CASES:
            for mode in ("highest", "high", "default"):
                seen.clear()
                x, w, spec = _pass_case(case, cuda)
                _pass_leaf(mode, x, w, spec)
                torch.cuda.synchronize()
                assert (torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32) == flags, (case[0], mode)
                on = mode != "highest"
                assert all(s == (on, on) for s in seen), (case[0], mode, seen)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("mode", ["high", "default"])
def test_each_mode_forward_on_the_card_matches_the_cpu(cuda, mode):
    cfg = PipelineConfig(view_num=3, max_d=32, max_h=64, max_w=96, fp32_precision=mode)
    scene = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
    torch.backends.cudnn.deterministic = True
    try:
        got = {dev: multi_view_forward(load_model(SPHERES, cfg, device=dev), scene["images"],
                                       scene["cams"], cfg)["depth"].cpu()
               for dev in ("cuda", "cpu")}
    finally:
        torch.backends.cudnn.deterministic = False
    d = (got["cuda"] - got["cpu"]).abs()
    mean_bound, max_bound = {"high": (2e-5, 1e-4), "default": (4e-4, 6e-3)}[mode]
    assert float(d.mean()) <= mean_bound and float(d.max()) <= max_bound
