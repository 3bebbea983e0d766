"""The port's standalone get_visual_hull against the JAX package's, and against the hull
that the port's refinement computes inline from its shared nearest warp.

The hull is a count of views over the view count, so it is compared exactly. A count flips
only where the nearest warp rounds to another source pixel (a sample coordinate within fp32
noise of a half-integer, or of the validity window's edge) or where a warped depth equals
a sweep value to the last bit; the scenes have off-axis baselines, which keeps samples off
the pixel lattice, and at most 1e-4 of the voxels are allowed to differ between the two
packages. The inline hull uses the same functions on the same inputs: no voxel may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.geometry.visual_hull import get_visual_hull as jax_visual_hull
from atvsnet_torch.geometry.homography import get_homographies, sweep_depths
from atvsnet_torch.geometry.visual_hull import get_visual_hull
from atvsnet_torch.geometry.warp import plane_sweep_warp_with_nearest, transform_depth

from tests._utils import make_cam, rotation

torch.set_num_threads(2)
MAX_FLIPPED_SHARE = 1e-4


def _scene(N, H, W, D, inverse, seed, holes=True):
    """(B=2, N) depth maps in sweep units around the middle of the sweep, and cams."""
    rng = np.random.RandomState(seed)
    K = np.array([[W * 1.0, 0, W / 2.0 + 0.3], [0, W * 1.0, H / 2.0 - 0.2], [0, 0, 1.0]])
    start, interval = (0.5, 0.5 / D) if inverse else (1.0, 1.0 / D)
    cams = np.stack([[make_cam(K, rotation([0.1, 1.0, 0.2], 0.03 * v + 0.01 * b),
                               np.array([0.06 * v, 0.023 * v, 0.004 * v]), start, interval, D)
                      for v in range(N)] for b in range(2)]).astype(np.float32)
    depth = start + interval * D * (0.2 + 0.6 * rng.rand(2, N, H, W))
    if holes:
        depth[rng.rand(2, N, H, W) < 0.1] = 0.0
    start_b = np.full((2,), start, np.float32)
    interval_b = np.full((2,), interval, np.float32)
    return depth.astype(np.float32), cams, start_b, interval_b


def _both(depth, cams, D, start, interval, **kw):
    got = get_visual_hull(torch.from_numpy(depth), torch.from_numpy(cams), D,
                          torch.from_numpy(start), torch.from_numpy(interval), **kw).numpy()
    want = np.asarray(jax_visual_hull(jnp.asarray(depth), jnp.asarray(cams), D,
                                      jnp.asarray(start), jnp.asarray(interval), **kw))
    return got, want


@pytest.mark.parametrize("N,inverse,kw", [
    (2, True, {}), (2, False, {}), (3, True, {}), (4, True, {"ref_id": 2}),
    (4, False, {"ref_id": 1}), (4, True, {"view_num": 3}), (5, True, {"ref_id": 4}),
])
def test_matches_jax(N, inverse, kw):
    H, W, D = 20, 28, 8
    depth, cams, start, interval = _scene(N, H, W, D, inverse, seed=N + 10 * inverse)
    got, want = _both(depth, cams, D, start, interval, inverse_depth=inverse, **kw)
    assert got.shape == want.shape == (2, D, H, W, 1) and got.dtype == np.float32
    views = kw.get("view_num", N)
    # counts over the view count: every value is k / views
    np.testing.assert_allclose(got * views, np.round(got * views), atol=1e-5)
    assert 0.0 <= got.min() and got.max() <= 1.0 and 0.1 < got.mean() < 0.9
    flipped = got != want
    assert flipped.mean() <= MAX_FLIPPED_SHARE, flipped.mean()
    assert np.abs(got - want).max(initial=0) <= 1.0 / views + 1e-6


def test_zero_depth_claims_no_free_space():
    H, W, D = 12, 16, 8
    depth, cams, start, interval = _scene(2, H, W, D, True, seed=3, holes=False)
    depth[:, 0] = 0.0                                    # the reference map is all filtered
    got, want = _both(depth, cams, D, start, interval)
    np.testing.assert_array_equal(got, want)
    assert got.max() <= 0.5
    depth[:] = 0.0
    got, _ = _both(depth, cams, D, start, interval)
    # an invalid nearest sample reads pixel (0, 0), which is 0 here: nothing is free
    assert (got == 0).all()


@pytest.mark.parametrize("inverse", [True, False])
def test_equals_the_refinements_inline_hull(inverse):
    """models/tvsnet.refinement's hull, written out: the nearest warp that shares its
    coordinates with the bilinear one, on a per-pair stack [ref, view]."""
    H, W, D, F = 20, 28, 8, 4
    depth, cams, start, interval = _scene(2, H, W, D, inverse, seed=21)
    depth_t, cams_t = torch.from_numpy(depth), torch.from_numpy(cams)
    start_t, interval_t = torch.from_numpy(start), torch.from_numpy(interval)
    hull = get_visual_hull(depth_t, cams_t, D, start_t, interval_t, inverse_depth=inverse)

    ref_cam, view_cam = cams_t[:, 0], cams_t[:, 1]
    depth_ref, depth_view = depth_t[:, 0, ..., None], depth_t[:, 1, ..., None]
    shallow_view = torch.from_numpy(np.random.RandomState(0).rand(2, H, W, F).astype(np.float32))
    dvt = transform_depth(depth_view, view_cam, ref_cam, inverse)
    homographies = get_homographies(ref_cam, view_cam, D, start_t, interval_t, inverse)
    _, warped_near, _ = plane_sweep_warp_with_nearest(
        torch.cat([shallow_view, dvt], dim=-1), homographies, nearest_slice=slice(F, F + 1))
    sweep_hw = sweep_depths(start_t, interval_t, D)[:, :, None, None]

    def free_space(d):
        cmp = d > sweep_hw if inverse else sweep_hw > d
        return ((d > 0) & cmp).to(torch.float32)

    inline = (free_space(depth_ref[..., 0][:, None]) + free_space(warped_near[..., 0])) / 2.0
    assert torch.equal(hull[..., 0], inline)
    assert 0.1 < float(inline.mean()) < 0.9
