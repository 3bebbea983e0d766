"""The port's soft-argmin (plain version and dispatch) against the JAX package's (CPU).

The JAX side runs its Pallas kernel in interpret mode, or its XLA formula, as
tests/test_pallas_ops.py does. Tolerance rtol 1e-5 / atol 1e-6, the same as the JAX
package holds its kernel to: both compute one fp32 softmax over D and differ only in
the order of the sums. The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.geometry.depth_regression import prob2depth as jprob2depth
from atvsnet_tpu.ops.softargmin import softargmin as jsoftargmin
from atvsnet_torch.geometry.depth_regression import prob2depth
from atvsnet_torch.ops import softargmin as S

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(B, D, h, w, seed):
    rng = np.random.RandomState(seed)
    cost = rng.randn(B, D, h, w).astype(np.float32)
    ds = rng.uniform(0.3, 1.0, B).astype(np.float32)
    di = rng.uniform(0.01, 0.1, B).astype(np.float32)
    return cost, ds, di


@pytest.mark.parametrize("shape", [(2, 16, 8, 24), (1, 8, 6, 8), (2, 16, 3, 37)])
def test_plain_matches_pallas_interpret(shape):
    cost, ds, di = _inputs(*shape, seed=0)
    D = shape[1]
    ref = np.asarray(jsoftargmin(jnp.asarray(cost), D, jnp.asarray(ds), jnp.asarray(di),
                                 interpret=True))
    got = S.softargmin(torch.from_numpy(cost), D, torch.from_numpy(ds), torch.from_numpy(di))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_matches_xla_wide():
    """The 4096-wide case the TPU kernel could not hold in VMEM."""
    cost, ds, di = _inputs(1, 128, 8, 4096, seed=1)
    ref = np.asarray(jprob2depth(jnp.asarray(cost), 128, jnp.asarray(ds), jnp.asarray(di),
                                 impl="xla"))
    got = prob2depth(torch.from_numpy(cost), 128, torch.from_numpy(ds), torch.from_numpy(di))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_peaked_volume():
    cost = np.zeros((1, 8, 4, 8), np.float32)
    cost[:, 3] = -60.0
    got = S.softargmin_torch(torch.from_numpy(cost), torch.tensor([1.0]), torch.tensor([0.5]))
    np.testing.assert_allclose(got.numpy(), 1.0 + 3 * 0.5, atol=1e-4)


def test_bf16_input_reads_as_fp32():
    cost, ds, di = _inputs(1, 16, 4, 8, seed=2)
    c16 = torch.from_numpy(cost).to(torch.bfloat16)
    ref = np.asarray(jsoftargmin(jnp.asarray(c16.float().numpy()).astype(jnp.bfloat16), 16,
                                 jnp.asarray(ds), jnp.asarray(di), interpret=True))
    got = S.softargmin_torch(c16, torch.from_numpy(ds), torch.from_numpy(di))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    cost, ds, di = _inputs(1, 8, 4, 4, seed=3)
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    before = S.softargmin_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin(args[0], 8, *args[1:], impl="cuda")
    assert S.softargmin_cuda.launches == before


def test_dispatch_picks_plain_version_for_cpu_tensors():
    cost, ds, di = _inputs(1, 8, 4, 4, seed=4)
    args = (torch.from_numpy(cost), 8, torch.from_numpy(ds), torch.from_numpy(di))
    before = S.softargmin_cuda.launches
    for impl in ("auto", "torch"):
        got = S.softargmin(*args, impl=impl)
        np.testing.assert_array_equal(got.numpy(), S.softargmin_torch(args[0], *args[2:]).numpy())
    assert S.softargmin_cuda.launches == before
    with pytest.raises(ValueError, match="planes"):
        S.softargmin(args[0], 16, *args[2:])


@pytest.mark.parametrize("slices", [1, 2, 8])
@pytest.mark.parametrize("D", [1, 12, 16, 130])
def test_split_version_matches_pallas_interpret(D, slices):
    """The mirror of the CUDA kernel's arithmetic (D in slices, chunks of 8, base-2
    exponents) against the JAX kernel: same tolerance, the sums only change order."""
    cost, ds, di = _inputs(2, D, 3, 8, seed=10 + D)
    ref = np.asarray(jsoftargmin(jnp.asarray(cost), D, jnp.asarray(ds), jnp.asarray(di),
                                 interpret=True))
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    got = S.softargmin_split_torch(*args, slices=slices)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), S.softargmin_torch(*args).numpy(), rtol=RTOL, atol=ATOL)


def _with_inf(cost, which):
    """+inf cost at every other pixel of the last row: the first chunk of 8 planes, the whole
    second quarter of D, or every plane but one."""
    cost = cost.copy()
    D = cost.shape[1]
    if which == "leading8":
        cost[:, :8, -1, ::2] = np.inf
    elif which == "slice":
        cost[:, D // 4:D // 2, -1, ::2] = np.inf
    else:
        keep = cost[:, D // 3, -1, ::2].copy()
        cost[:, :, -1, ::2] = np.inf
        cost[:, D // 3, -1, ::2] = keep
    return cost


@pytest.mark.parametrize("slices", [1, 4, 8])
@pytest.mark.parametrize("which", ["leading8", "slice", "all_but_one"])
def test_inf_planes_get_probability_zero(which, slices):
    """Planes of +inf cost mixed with finite ones: the plain version, the split version and
    the JAX kernel agree on a finite depth. The running update and the combine both meet a
    max of -inf here (a first chunk or a whole slice that is all +inf)."""
    cost, ds, di = _inputs(2, 32, 3, 8, seed=20)
    cost = _with_inf(cost, which)
    ref = np.asarray(jsoftargmin(jnp.asarray(cost), 32, jnp.asarray(ds), jnp.asarray(di),
                                 interpret=True))
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    plain = S.softargmin_torch(*args).numpy()
    split = S.softargmin_split_torch(*args, slices=slices).numpy()
    assert np.isfinite(ref).all() and np.isfinite(plain).all() and np.isfinite(split).all()
    np.testing.assert_allclose(plain, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(split, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slices", [1, 4])
def test_all_inf_pixel_is_nan_as_in_the_plain_version(slices):
    cost, ds, di = _inputs(1, 16, 2, 4, seed=21)
    cost[:, :, 1, 2] = np.inf
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    plain = S.softargmin_torch(*args)
    split = S.softargmin_split_torch(*args, slices=slices)
    expected = torch.zeros(1, 2, 4, 1, dtype=torch.bool)
    expected[0, 1, 2] = True
    assert torch.equal(torch.isnan(plain), expected) and torch.equal(torch.isnan(split), expected)
    torch.testing.assert_close(split[~expected], plain[~expected], rtol=RTOL, atol=ATOL)


def test_split_version_rejects_bad_slice_counts():
    cost, ds, di = _inputs(1, 8, 2, 4, seed=22)
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    with pytest.raises(ValueError, match="positive"):
        S.softargmin_split_torch(*args, slices=0)
    with pytest.raises(ValueError, match="positive"):
        S.softargmin_split_torch(*args, slices=2, chunk=0)


@pytest.mark.parametrize("ptr,hw,dtype,path", [
    (0x7f0000000000, 120 * 224, torch.float32, "aligned"),    # the main path's native call
    (0x7f0000000000, 120 * 896, torch.float32, "aligned"),    # and its upsample row tile
    (0x7f0000000000, 120 * 224, torch.bfloat16, "aligned"),
    (0x7f0000000010, 8 * 4095, torch.float32, "aligned"),     # odd width, h*w still a multiple of 4
    (0x7f0000000000, 3 * 33, torch.float32, "scalar"),        # odd h*w
    (0x7f0000000000, 5 * 7, torch.bfloat16, "scalar"),
    (0x7f0000000000, 4 * 5, torch.bfloat16, "scalar"),        # 40-byte planes
    (0x7f0000000000, 4 * 6, torch.bfloat16, "aligned"),       # 48-byte planes
    (0x7f0000000004, 120 * 224, torch.float32, "scalar"),     # a view one element into a buffer
    (0x7f0000000002, 120 * 224, torch.bfloat16, "scalar"),
    (0x7f0000000008, 120 * 224, torch.float32, "scalar"),
])
def test_kernel_path_is_a_function_of_pointer_plane_size_and_dtype(ptr, hw, dtype, path):
    assert S.kernel_path(ptr, hw, dtype) == path


def test_path_counters_do_not_move_without_a_launch():
    cost, ds, di = _inputs(1, 8, 4, 4, seed=5)
    before = dict(S.softargmin_cuda.path_launches)
    assert set(before) == set(S.PATHS) == {"aligned", "scalar"}
    S.softargmin(torch.from_numpy(cost), 8, torch.from_numpy(ds), torch.from_numpy(di))
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin_cuda(torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    assert S.softargmin_cuda.path_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [None, "leading8", "slice", "all_but_one"])
def test_plain_forward_with_stats(which, dtype):
    """The plain forward with its softmax statistics, which the gradient kernel is fed:
    the depth is JAX's (interpret mode) and the same, to the bit, as without statistics;
    the statistics are rows 0-1 of softargmin_partial_torch at offset 0, the max of -cost
    to the bit and the sum of exp(-cost - max) at rtol 1e-5 against numpy."""
    cost, ds, di = _inputs(2, 32, 3, 8, seed=30)
    if which is not None:
        cost = _with_inf(cost, which)
    c = torch.from_numpy(cost).to(dtype)
    args = (c, torch.from_numpy(ds), torch.from_numpy(di))
    depth, stats = S.softargmin_torch(*args, with_stats=True)
    ref = np.asarray(jsoftargmin(jnp.asarray(c.float().numpy()).astype(jnp.dtype(str(dtype)[6:])),
                                 32, jnp.asarray(ds), jnp.asarray(di), interpret=True))
    np.testing.assert_allclose(depth.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(depth, S.softargmin_torch(*args))
    assert stats.shape == (2, 2, 3, 8) and stats.dtype == torch.float32
    assert torch.equal(stats, S.softargmin_partial_torch(*args, offset=0)[:2])
    v = -c.float().numpy()
    m = v.max(axis=1)
    np.testing.assert_array_equal(stats[0].numpy(), m)
    np.testing.assert_allclose(stats[1].numpy(), np.exp(v - m[:, None]).sum(axis=1), rtol=1e-5)


def test_plain_forward_stats_of_an_all_inf_pixel():
    """A pixel whose planes are all +inf: max -inf, sum 0 (taken against 0), depth NaN."""
    cost, ds, di = _inputs(1, 16, 2, 4, seed=31)
    cost[:, :, 1, 2] = np.inf
    depth, stats = S.softargmin_torch(torch.from_numpy(cost), torch.from_numpy(ds),
                                      torch.from_numpy(di), with_stats=True)
    assert bool(torch.isnan(depth[0, 1, 2]).all()) and int(torch.isnan(depth).sum()) == 1
    assert float(stats[0, 0, 1, 2]) == -np.inf and float(stats[1, 0, 1, 2]) == 0.0
    assert bool(torch.isfinite(stats[:, 0, 0]).all())


# ---- the depth split's partial forward: the mirror of its kernel's arithmetic ----

def _merge_halves(t0, t1):
    """Two ranks' triples (3, B, h, w) merged into one, as the ranks' all-reduces do."""
    m = torch.maximum(t0[0], t1[0])
    ref = S.finite_or_zero(m)
    sums = t0[1:] * torch.exp(t0[0] - ref) + t1[1:] * torch.exp(t1[0] - ref)
    return torch.cat([m[None], sums])


@pytest.mark.parametrize("D,chunks,batch", [(16, 1, 4), (16, 4, 4), (13, 2, 4), (13, 4, 1),
                                            (40, 8, 2), (65, 2, 4), (12, 8, 3)])
def test_partial_split_version_merged_matches_pallas_interpret(D, chunks, batch):
    """The mirror of the partial kernel (D in chunks, 4 warps taking planes in turn, folds of
    `batch` planes, the warps' and the chunks' merges) on the two halves of a 2D-plane
    volume, merged as two ranks are by merge_partials, against the JAX kernel on the whole
    volume: the sums only change order. Some chunk counts do not divide D."""
    cost, ds, di = _inputs(2, 2 * D, 3, 8, seed=40 + D)
    ref = np.asarray(jsoftargmin(jnp.asarray(cost), 2 * D, jnp.asarray(ds), jnp.asarray(di),
                                 interpret=True))
    c, s, i = torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di)
    halves = [S.softargmin_partial_split_torch(c[:, k * D:(k + 1) * D].contiguous(), s, i, k * D,
                                               chunks=chunks, batch=batch) for k in range(2)]
    depth, stats = S.merge_partials(_merge_halves(*halves), None)
    assert depth.shape == ref.shape and depth.dtype == torch.float32
    np.testing.assert_allclose(depth.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(stats[0].numpy(), (-cost).max(axis=1))


@pytest.mark.parametrize("chunks,batch", [(1, 4), (2, 4), (4, 2), (8, 4), (3, 1)])
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0), (torch.float32, 37),
                                          (torch.bfloat16, 64)])
def test_partial_split_version_matches_partial_torch(dtype, offset, chunks, batch):
    """The mirror's triple against the plain partial forward: the max to the bit, the two
    sums at rtol 1e-5."""
    cost, ds, di = _inputs(2, 33, 3, 8, seed=50)
    c = torch.from_numpy(cost).to(dtype)
    args = (c, torch.from_numpy(ds), torch.from_numpy(di), offset)
    got = S.softargmin_partial_split_torch(*args, chunks=chunks, batch=batch)
    ref = S.softargmin_partial_torch(*args)
    assert got.shape == (3, 2, 3, 8) and got.dtype == torch.float32
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1:], ref[1:], rtol=1e-5, atol=0)


def _inf_at(cost, which, D):
    """+inf cost at every other pixel of the last row: the first chunk of 4 (planes 0-7 of
    32), the third, the planes of warp 1 in every chunk, or every plane (an all-+inf pixel)."""
    cost = cost.copy()
    planes = {"first chunk": slice(0, D // 4), "third chunk": slice(D // 2, 3 * D // 4),
              "one warp": slice(1, D, 4), "all": slice(0, D)}[which]
    cost[:, planes, -1, ::2] = np.inf
    return cost


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("which", ["first chunk", "third chunk", "one warp", "all"])
def test_partial_split_version_with_inf_planes(which, chunks):
    """+inf planes that fill whole batches, warps or chunks: the mirror agrees with the
    plain partial forward; where every plane of a pixel is +inf the triple is (-inf, 0, 0)."""
    cost, ds, di = _inputs(1, 32, 3, 8, seed=51)
    cost = _inf_at(cost, which, 32)
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di), 32)
    got = S.softargmin_partial_split_torch(*args, chunks=chunks, batch=2)
    ref = S.softargmin_partial_torch(*args)
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1:], ref[1:], rtol=1e-5, atol=0)
    inf_pixels = got[:, :, -1, ::2]
    if which == "all":
        assert bool(torch.isneginf(inf_pixels[0]).all()) and bool((inf_pixels[1:] == 0).all())
    else:
        assert bool(torch.isfinite(got).all()) and bool((got[1] > 0).all())


def test_partial_split_version_rejects_bad_grids():
    cost, ds, di = _inputs(1, 8, 2, 4, seed=52)
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di))
    for bad in (dict(chunks=0), dict(warps=0), dict(batch=0)):
        with pytest.raises(ValueError, match="positive"):
            S.softargmin_partial_split_torch(*args, **bad)


@pytest.mark.parametrize("dtype,path,pixels", [(torch.float32, "aligned", 4),
                                               (torch.bfloat16, "aligned", 8),
                                               (torch.float32, "scalar", 1),
                                               (torch.bfloat16, "scalar", 1)])
def test_packet_pixels_of_each_path(dtype, path, pixels):
    """What the grid queries and the empty launch hand the library: pixels per packet."""
    assert S.packet_pixels(dtype, path) == pixels
    with pytest.raises(ValueError, match="path"):
        S.packet_pixels(dtype, "vector")


def test_partial_wrapper_refuses_cpu_tensors():
    cost, ds, di = _inputs(1, 8, 4, 4, seed=53)
    args = (torch.from_numpy(cost), torch.from_numpy(ds), torch.from_numpy(di), 8)
    before = (S.softargmin_partial_cuda.launches, dict(S.softargmin_partial_cuda.path_launches))
    with pytest.raises(ValueError, match="CUDA"):
        S.softargmin_partial_cuda(*args)
    assert (S.softargmin_partial_cuda.launches, S.softargmin_partial_cuda.path_launches) == before
