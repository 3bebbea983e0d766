"""The soft-argmin's gradient: the port's plain routes against the JAX package's (CPU).

The JAX backward is jax.vjp of its XLA formula (`_softargmin_xla`, which `_fused_bwd`
differentiates). On the same seeded volumes, sweeps and incoming gradients:
  * SoftArgminFunction's wiring (what it saves: the forward's softmax statistics beside
    the depth; the dtypes; no gradient for the sweep), with the two kernel launchers stood
    in for by their plain versions: the forward by softargmin_torch with its statistics,
    the backward by the stats-fed softargmin_backward_stats_torch at offset 0, as the one
    gradient kernel serves both; the Function itself launches the kernels only and raises
    for a CPU tensor;
  * softargmin_backward_torch, the closed form, on the JAX forward's own depth, and the
    stats-fed plain backward at offset 0 on the plain forward's depth and statistics;
  * autograd of softargmin_split_torch, the mirror of the kernel's arithmetic.
Volumes: random, peaked (one plane 60 below the rest), and with planes of +inf cost
(probability and gradient 0 there; a pixel whose planes are all +inf is NaN in both).

Bounds. fp32: rtol 1e-5 plus an atol of 1e-5 * max|g| * max|sweep|: the XLA formula's
backward is p * (g*sweep - sum p*g*sweep), a difference of two values of that size,
while the closed form subtracts sweep - depth; measured at most 1.1e-7 of that scale.
bf16 costs: both packages round the same fp32 gradient to bf16, so one bf16 ulp
(rtol 8e-3) on top; measured at most 6.2e-6 of that scale. The CUDA kernels are held
against these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.ops.softargmin import _softargmin_xla
from atvsnet_torch.ops import softargmin as S

torch.set_num_threads(2)


def _volume(kind, dtype, seed=0, shape=(2, 24, 6, 10)):
    rng = np.random.RandomState(seed)
    B, D = shape[:2]
    cost = (rng.randn(*shape) * 3).astype(np.float32)
    if kind == "peaked":
        cost[:, :, ::2] = 0.0
        cost[:, 5, ::2] = -60.0
    elif kind == "inf":
        cost[:, : D // 3, :, ::3] = np.inf      # the first third of D at every 3rd column
        cost[:, :, 0, 0] = np.inf               # every plane of pixel (0, 0)
    start = rng.uniform(0.3, 1.0, B).astype(np.float32)
    interval = rng.uniform(0.01, 0.1, B).astype(np.float32)
    g = rng.randn(B, *shape[2:], 1).astype(np.float32)
    if dtype == "bfloat16":
        cost = np.array(jnp.asarray(cost, jnp.bfloat16).astype(jnp.float32))
    return cost, start, interval, g


def _jax_grad(cost, start, interval, g, dtype):
    D = cost.shape[1]
    sweep = start[:, None] + np.arange(D, dtype=np.float32)[None] * interval[:, None]
    c = jnp.asarray(cost, jnp.dtype(dtype))
    depth, vjp = jax.vjp(_softargmin_xla, c, jnp.asarray(sweep))
    grad_cost, _ = vjp(jnp.asarray(g))
    return np.asarray(depth), np.asarray(grad_cost.astype(jnp.float32)), float(np.abs(sweep).max())


def _torch(cost, start, interval, dtype):
    t = torch.from_numpy(cost).to(getattr(torch, dtype))
    return t, torch.from_numpy(start), torch.from_numpy(interval)


def _stats_fed_backward(cost, start, interval, stats, depth, grad):
    """The plain version of softargmin_backward_cuda: the stats-fed backward at offset 0."""
    return S.softargmin_backward_stats_torch(cost, start, interval, 0, stats, depth, grad)


@pytest.fixture
def plain_launchers(monkeypatch):
    """The kernel launchers replaced by their plain versions, so that SoftArgminFunction
    runs on CPU tensors."""
    monkeypatch.setattr(S, "softargmin_cuda", S.softargmin_torch)
    monkeypatch.setattr(S, "softargmin_backward_cuda", _stats_fed_backward)


def _compare(got, ref, g, sweep_max, dtype):
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * np.abs(g).max() * sweep_max)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))


CASES = [(kind, dtype) for kind in ("random", "peaked", "inf") for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_function_plain_route_matches_jax_vjp(plain_launchers, kind, dtype):
    cost, start, interval, g = _volume(kind, dtype)
    _, ref, sweep_max = _jax_grad(cost, start, interval, g, dtype)
    c, s, i = _torch(cost, start, interval, dtype)
    c.requires_grad_(True)
    depth = S.SoftArgminFunction.apply(c, s, i)
    depth.backward(torch.from_numpy(g))
    assert c.grad.dtype == c.dtype and depth.dtype == torch.float32
    _compare(c.grad.float().numpy(), ref, g, sweep_max, dtype)
    if kind == "inf":
        # +inf planes get probability 0 and gradient 0; pixel (0, 0) is NaN in every plane
        grad = c.grad.float().numpy()
        assert np.isnan(grad[:, :, 0, 0]).all() and np.isnan(grad).sum() == grad.shape[0] * grad.shape[1]
        finite_inf = np.isinf(cost) & ~np.isnan(grad)
        assert finite_inf.any() and (grad[finite_inf] == 0).all()


@pytest.mark.parametrize("kind,dtype", CASES)
def test_closed_form_matches_jax_vjp(kind, dtype):
    cost, start, interval, g = _volume(kind, dtype, seed=1)
    depth, ref, sweep_max = _jax_grad(cost, start, interval, g, dtype)
    c, s, i = _torch(cost, start, interval, dtype)
    got = S.softargmin_backward_torch(c, s, i, torch.from_numpy(depth), torch.from_numpy(g))
    assert got.dtype == c.dtype and got.shape == c.shape
    _compare(got.float().numpy(), ref, g, sweep_max, dtype)


@pytest.mark.parametrize("kind,dtype", CASES)
def test_stats_fed_backward_at_offset_0_matches_jax_vjp(kind, dtype):
    """What the gradient kernel computes for the whole volume: the stats-fed backward at
    offset 0 from the plain forward's depth and statistics, against jax.vjp."""
    cost, start, interval, g = _volume(kind, dtype, seed=9)
    _, ref, sweep_max = _jax_grad(cost, start, interval, g, dtype)
    c, s, i = _torch(cost, start, interval, dtype)
    depth, stats = S.softargmin_torch(c, s, i, with_stats=True)
    got = S.softargmin_backward_stats_torch(c, s, i, 0, stats, depth, torch.from_numpy(g))
    assert got.dtype == c.dtype and got.shape == c.shape
    _compare(got.float().numpy(), ref, g, sweep_max, dtype)


@pytest.mark.parametrize("kind", ["random", "inf"])
def test_function_saves_and_uses_the_forward_stats(monkeypatch, kind):
    """SoftArgminFunction's forward asks its launcher for the statistics, saves them, and
    its backward hands the same tensors (the saved statistics and depth) to the gradient
    launcher; the statistics are rows 0-1 of softargmin_partial_torch at offset 0."""
    seen = {}

    def forward(cost, start, interval, with_stats=False):
        seen["with_stats"] = with_stats
        seen["forward"] = S.softargmin_torch(cost, start, interval, with_stats=with_stats)
        return seen["forward"]

    def backward(cost, start, interval, stats, depth, grad):
        seen["backward"] = (stats, depth)
        return _stats_fed_backward(cost, start, interval, stats, depth, grad)

    monkeypatch.setattr(S, "softargmin_cuda", forward)
    monkeypatch.setattr(S, "softargmin_backward_cuda", backward)
    cost, start, interval, g = _volume(kind, "float32", seed=10)
    c, s, i = _torch(cost, start, interval, "float32")
    leaf = c.clone().requires_grad_(True)
    S.SoftArgminFunction.apply(leaf, s, i).backward(torch.from_numpy(g))
    assert seen["with_stats"] is True
    depth, stats = seen["forward"]
    assert seen["backward"][0] is stats
    torch.testing.assert_close(seen["backward"][1], depth, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(stats, S.softargmin_partial_torch(c, s, i, 0)[:2])
    ref = S.softargmin_backward_torch(c, s, i, depth.detach(), torch.from_numpy(g))
    sweep_max = float(S.sweep(c.shape[1], s, i).abs().max())
    _compare(leaf.grad.numpy(), ref.numpy(), g, sweep_max, "float32")


@pytest.mark.parametrize("kind", ["random", "peaked", "inf"])
@pytest.mark.parametrize("slices", [2, 8, 16])
def test_split_mirror_autograd_matches_jax_vjp(kind, slices):
    cost, start, interval, g = _volume(kind, "float32", seed=2)
    _, ref, sweep_max = _jax_grad(cost, start, interval, g, "float32")
    c, s, i = _torch(cost, start, interval, "float32")
    c.requires_grad_(True)
    S.softargmin_split_torch(c, s, i, slices=slices, chunk=4).backward(torch.from_numpy(g))
    _compare(c.grad.numpy(), ref, g, sweep_max, "float32")


def test_gradcheck_float64(plain_launchers):
    """The plain forward's autograd and the Function's stats-fed backward (through the
    plain launchers: the forward's statistics, offset 0), in float64, against finite
    differences."""
    rng = np.random.RandomState(3)
    cost = torch.from_numpy(rng.randn(2, 7, 3, 4) * 2).requires_grad_(True)
    start = torch.tensor([0.5, 0.8], dtype=torch.float64)
    interval = torch.tensor([0.05, 0.02], dtype=torch.float64)
    assert torch.autograd.gradcheck(lambda c: S.softargmin_torch(c, start, interval), (cost,))
    assert torch.autograd.gradcheck(lambda c: S.SoftArgminFunction.apply(c, start, interval),
                                    (cost,))


def test_dispatch_under_grad_and_no_grad():
    """On a CPU tensor `softargmin` keeps the plain formula (autograd derives its
    gradient) whatever grad mode says; the kernel route on a CPU tensor raises with grad
    and without it, and so does the Function; the sweep takes no gradient."""
    cost, start, interval, g = _volume("random", "float32", seed=4)
    c, s, i = _torch(cost, start, interval, "float32")
    leaf = c.clone().requires_grad_(True)
    out = S.softargmin(leaf, c.shape[1], s, i)
    assert out.grad_fn is not None and "SoftArgminFunction" not in type(out.grad_fn).__name__
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin(leaf, c.shape[1], s, i, impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        S.softargmin(leaf, c.shape[1], s, i, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        S.SoftArgminFunction.apply(leaf, s, i)
    with pytest.raises(ValueError, match="cost only"):
        S.SoftArgminFunction.apply(leaf, s.clone().requires_grad_(True), i)
    _, stats = S.softargmin_torch(c, s, i, with_stats=True)
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin_backward_cuda(c, s, i, stats, out.detach(), torch.from_numpy(g))


# ---- the soft-argmin over a split D (parallel.depth): partial forward, merge, stats-fed
# backward. One process: DepthSplit(None, 0, 1, D) merges and sums over itself alone; the
# multi-rank merge is held on gloo worlds in tests/test_torch_parallel_depth*.py. ----

@pytest.fixture
def plain_split_launchers(monkeypatch):
    """The split kernels' launchers replaced by their plain versions, so that
    SplitSoftArgminFunction's kernel route runs on CPU tensors."""
    monkeypatch.setattr(S, "softargmin_partial_cuda", S.softargmin_partial_torch)
    monkeypatch.setattr(S, "softargmin_backward_stats_cuda", S.softargmin_backward_stats_torch)


def _one_rank(depth_num):
    from atvsnet_torch.parallel.depth import DepthSplit
    return DepthSplit(None, 0, 1, depth_num)


@pytest.mark.parametrize("kind,dtype", CASES)
def test_split_function_matches_jax_vjp(plain_split_launchers, kind, dtype):
    cost, start, interval, g = _volume(kind, dtype, seed=5)
    depth, ref, sweep_max = _jax_grad(cost, start, interval, g, dtype)
    c, s, i = _torch(cost, start, interval, dtype)
    c.requires_grad_(True)
    got = S.SplitSoftArgminFunction.apply(c, s, i, _one_rank(c.shape[1]), True)
    got.backward(torch.from_numpy(g))
    assert c.grad.dtype == c.dtype and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), depth, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()), np.isnan(depth))
    _compare(c.grad.float().numpy(), ref, g, sweep_max, dtype)


@pytest.mark.parametrize("kind", ["random", "peaked", "inf"])
def test_split_function_matches_autograd_of_the_plain_forward(plain_split_launchers, kind):
    """The Function's kernel route (plain launchers) and its plain route against
    torch.autograd.grad of softargmin_torch over the whole D."""
    cost, start, interval, g = _volume(kind, "float32", seed=6)
    c, s, i = _torch(cost, start, interval, "float32")
    leaf = c.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(S.softargmin_torch(leaf, s, i), leaf, torch.from_numpy(g))
    sweep_max = float(S.sweep(c.shape[1], s, i).abs().max())
    for use_kernel in (True, False):
        leaf = c.clone().requires_grad_(True)
        depth = S.softargmin(leaf, c.shape[1], s, i, impl="cuda" if use_kernel else "torch",
                             split=_one_rank(c.shape[1]))
        (got,) = torch.autograd.grad(depth, leaf, torch.from_numpy(g))
        _compare(got.numpy(), want.numpy(), g, sweep_max, "float32")


@pytest.mark.parametrize("kind", ["random", "peaked", "inf"])
@pytest.mark.parametrize("parts", [2, 3])
def test_partials_at_their_offsets_merge_to_the_whole(kind, parts):
    """Triples of D's blocks at their global offsets, merged as merge_partials merges the
    ranks' (the max over the blocks, each block's sums rescaled to it, summed), against
    softargmin_torch; and the stats-fed backward of each block against the closed form."""
    cost, start, interval, g = _volume(kind, "float32", seed=7, shape=(2, 24, 6, 10))
    c, s, i = _torch(cost, start, interval, "float32")
    blocks = [slice(k * 24 // parts, (k + 1) * 24 // parts) for k in range(parts)]
    triples = [S.softargmin_partial_torch(c[:, b], s, i, b.start) for b in blocks]
    m = torch.stack([t[0] for t in triples]).amax(dim=0)
    sums = sum(t[1:] * torch.exp(t[0] - S.finite_or_zero(m)) for t in triples)
    depth = (sums[1] / sums[0])[..., None]
    want = S.softargmin_torch(c, s, i)
    np.testing.assert_allclose(depth.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.isnan(depth.numpy()), np.isnan(want.numpy()))
    stats = torch.stack([m, sums[0]])
    gt = torch.from_numpy(g)
    got = torch.cat([S.softargmin_backward_stats_torch(c[:, b], s, i, b.start, stats, depth, gt)
                     for b in blocks], dim=1)
    ref = S.softargmin_backward_torch(c, s, i, depth, gt)
    _compare(got.numpy(), ref.numpy(), g, float(S.sweep(24, s, i).abs().max()), "float32")


def test_split_entry_points_take_cuda_tensors_only():
    cost, start, interval, g = _volume("random", "float32", seed=8)
    c, s, i = _torch(cost, start, interval, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin_partial_cuda(c, s, i, 0)
    depth, stats = S.merge_partials(S.softargmin_partial_torch(c, s, i), None)
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin_backward_stats_cuda(c, s, i, 0, stats, depth, torch.from_numpy(g))
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin(c, c.shape[1], s, i, impl="cuda", split=_one_rank(c.shape[1]))
    with pytest.raises(ValueError, match="planes"):
        S.softargmin(c, 2 * c.shape[1], s, i, split=_one_rank(c.shape[1]))
