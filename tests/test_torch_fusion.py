"""The port's consistency fusion against the JAX package's, on the CPU.

The same numpy scenes (those of tests/test_fusion.py, made from a seed) go through
atvsnet_tpu.fusion.consistency.fuse_depth_maps and atvsnet_torch's with device="cpu".

Tolerance. Both clouds come out ordered by (reference view, pixel in row-major order), so
they are matched through their order. `rel < disp_thresh` compares fp32 values whose
summation order differs between XLA-CPU and PyTorch-CPU, so a pixel within an ulp of the
threshold may emit in one and not in the other: points that only one cloud has number at
most 0.1% of the larger cloud (0 on scenes built away from the threshold). Matched points
agree in xyz to 1e-6 relative (both come from the float64 host back-projection) and in
colour to +-1. Within the port, the sparse path equals the dense one exactly, in order.
"""

import numpy as np
import pytest
import torch

from atvsnet_tpu.fusion import consistency as jcons
from atvsnet_tpu.fusion.dmb import fake_normals
from atvsnet_torch.fusion import consistency as tcons

from tests._utils import make_cam, rotation

torch.set_num_threads(2)

XYZ_RTOL, XYZ_ATOL, COLOUR_TOL, MAX_UNMATCHED_SHARE = 1e-6, 1e-6, 1, 1e-3


def plane_scene(V=3, H=24, W=32, z=4.0, seed=0, off_axis=False):
    """V cameras looking at the fronto-parallel plane z=const (tests/test_fusion.py's scene;
    off_axis adds a y and z component to the baseline and a second rotation axis)."""
    K = np.array([[40.0, 0, W / 2.0], [0, 40.0, H / 2.0], [0, 0, 1.0]])
    cams, depths, images = [], [], []
    rng = np.random.RandomState(seed)
    for v in range(V):
        if off_axis:
            R = rotation([0.2, 1, 0.1], 0.02 * v)
            t = np.array([0.15 * v, 0.04 * v, 0.01 * v])
        else:
            R = rotation([0, 1, 0], 0.02 * v)
            t = np.array([0.15 * v, 0.0, 0.0])
        cams.append(make_cam(K, R, t))
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
        rays_world = (pix @ np.linalg.inv(K).T) @ R
        C = -R.T @ t
        depths.append(((z - C[2]) / rays_world[..., 2]).astype(np.float32))
        images.append(rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
    return np.stack(depths), np.stack(images), np.stack(cams)


def with_holes(depths, share, seed):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(*depths.shape) < share, 0.0, depths).astype(np.float32)


def match_clouds(a, b):
    """Align two (points, colours) clouds that are ordered alike. Returns (pairs of
    indices, number of points that only one cloud has)."""
    pa, pb = a[0], b[0]

    def same(i, j):
        return np.allclose(pa[i], pb[j], rtol=XYZ_RTOL, atol=XYZ_ATOL)

    if pa.shape == pb.shape and np.allclose(pa, pb, rtol=XYZ_RTOL, atol=XYZ_ATOL):
        idx = np.arange(pa.shape[0])
        return np.stack([idx, idx], 1), 0
    pairs, extra, i, j, look = [], 0, 0, 0, 16
    while i < len(pa) and j < len(pb):
        if same(i, j):
            pairs.append((i, j))
            i, j = i + 1, j + 1
            continue
        skip_b = next((k for k in range(1, look) if j + k < len(pb) and same(i, j + k)), None)
        skip_a = next((k for k in range(1, look) if i + k < len(pa) and same(i + k, j)), None)
        if skip_b is not None and (skip_a is None or skip_b <= skip_a):
            extra, j = extra + skip_b, j + skip_b
        elif skip_a is not None:
            extra, i = extra + skip_a, i + skip_a
        else:
            extra, i, j = extra + 2, i + 1, j + 1
    extra += (len(pa) - i) + (len(pb) - j)
    return np.asarray(pairs, np.int64).reshape(-1, 2), extra


def assert_same_cloud(got, want, exact_set=False):
    """The fusion tolerance stated in the module docstring; returns the point count."""
    pairs, extra = match_clouds(got, want)
    larger = max(got[0].shape[0], want[0].shape[0])
    assert extra <= (0 if exact_set else MAX_UNMATCHED_SHARE * larger), (extra, larger)
    if larger == 0:
        return 0
    gi, wi = pairs[:, 0], pairs[:, 1]
    np.testing.assert_allclose(got[0][gi], want[0][wi], rtol=XYZ_RTOL, atol=XYZ_ATOL)
    colour = np.abs(got[1][gi].astype(np.int32) - want[1][wi].astype(np.int32))
    assert colour.max(initial=0) <= COLOUR_TOL
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[1].dtype == want[1].dtype == np.uint8
    if len(got) == 3:
        np.testing.assert_allclose(got[2][gi], want[2][wi], rtol=0, atol=1e-5)
    return larger


def both(depths, images, cams=None, **kw):
    want = jcons.fuse_depth_maps(depths, images, cams, **kw)
    got = tcons.fuse_depth_maps(depths, images, cams, device="cpu", **kw)
    return got, want


def _facing_rig():
    """View 1 stands BEHIND view 0 and faces it, so C_0 projects into view 1 with z < 0.
    Slightly off axis, so that no projection lands on the pixel lattice, where an ulp would
    decide the bounds test."""
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1.0]])
    return np.stack([
        make_cam(K, np.eye(3), np.zeros(3)),
        make_cam(K, rotation([0.03, 1, 0.02], np.pi), np.array([0.013, 0.021, -2.0])),
        make_cam(K, rotation([0.1, 1, 0.3], 0.01), np.array([0.1, 0.013, 0.004])),
    ])


def _scene(name):
    """(depths, images, cams, kwargs, minimum number of points) of a named case."""
    if name == "plane":
        return *plane_scene(V=3), {}, 1000
    if name == "plane_off_axis":
        return *plane_scene(V=4, off_axis=True, seed=1), {}, 1000
    if name == "inconsistent":
        d, i, c = plane_scene(V=3)
        d[1:] *= 1.5
        return d, i, c, {}, 0
    if name == "left_half_filtered":
        d, i, c = plane_scene(V=3)
        d[:, :, :16] = 0.0
        return d, i, c, {}, 100
    if name == "holes_in_every_view":
        d, i, c = plane_scene(V=4, off_axis=True, seed=2)
        return with_holes(d, 0.3, 7), i, c, {}, 100
    if name == "jitter":
        d, i, c = plane_scene(V=4, off_axis=True, seed=3)
        jitter = np.random.RandomState(5).randn(*d.shape).astype(np.float32) * 0.004 * d
        return (d + jitter).astype(np.float32), i, c, {}, 100
    if name == "num_consistent_3":
        return *plane_scene(V=4, off_axis=True, seed=4), {"num_consistent": 3}, 100
    if name == "float_images":
        d, i, c = plane_scene(V=3, off_axis=True, seed=5)
        return d, i.astype(np.float32) * 1.07 - 3.0, c, {}, 1000     # leaves 0..255 at both ends
    if name == "depth_range_keeps":
        return *plane_scene(V=3), {"depth_min": 3.0, "depth_max": 5.0}, 1000
    if name == "depth_range_drops":
        return *plane_scene(V=3), {"depth_max": 3.0}, 0
    if name == "all_filtered_facing_rig":
        rng = np.random.RandomState(0)
        return (np.zeros((3, 24, 32), np.float32),
                rng.randint(0, 255, (3, 24, 32, 3)).astype(np.uint8), _facing_rig(),
                {"num_consistent": 1}, 0)
    if name == "facing_rig_behind_passes":
        # the signed-division quirk: the plane's points lie BEHIND view 1, whose check
        # passes with rel <= 0; with num_consistent=1 that alone emits them
        d, i, _ = plane_scene(V=3)
        return d, i, _facing_rig(), {"num_consistent": 1}, 1000
    raise KeyError(name)


SCENES = ["plane", "plane_off_axis", "inconsistent", "left_half_filtered",
          "holes_in_every_view", "jitter", "num_consistent_3", "float_images",
          "depth_range_keeps", "depth_range_drops", "all_filtered_facing_rig",
          "facing_rig_behind_passes"]


@pytest.mark.parametrize("name", SCENES)
def test_cloud_matches_jax(name):
    depths, images, cams, kw, at_least = _scene(name)
    got, want = both(depths, images, cams, **kw)
    n = assert_same_cloud(got, want)
    assert n >= at_least and (at_least > 0 or n == 0), n


def test_point_on_another_cameras_plane():
    """A reference pixel whose point lies exactly on view 1's plane z = 0 projects there
    to +-inf or NaN: the sample index must stay defined and the point set the reference's."""
    depths, images, cams = plane_scene(V=3, off_axis=True, seed=6)
    P, M_inv, centers, _ = tcons.camera_geometry(cams)
    # move camera 1 so that the point of reference pixel (12, 16) has z = 0 in it
    X = M_inv[0].astype(np.float64) @ (depths[0, 12, 16] * np.array([16.0, 12.0, 1.0])
                                       - P[0, :, 3].astype(np.float64))
    R1 = cams[1, 0, :3, :3].astype(np.float64)
    cams = cams.copy()
    cams[1, 0, :3, 3] -= np.array([0.0, 0.0, (R1 @ X + cams[1, 0, :3, 3])[2]], np.float32)
    z = (R1 @ X + cams[1, 0, :3, 3])[2]
    assert abs(z) < 1e-6
    got, want = both(depths, images, cams, num_consistent=1)
    assert assert_same_cloud(got, want) > 0
    assert np.isfinite(got[0]).all()


def test_p_matrices_entry():
    depths, images, cams = plane_scene(V=3, off_axis=True, seed=8)
    P64 = cams[:, 1, :3, :3].astype(np.float64) @ cams[:, 0, :3, :4].astype(np.float64)
    got, want = both(depths, images, None, P_matrices=P64)
    assert assert_same_cloud(got, want) > 1000
    # the same cloud as through cams: the focal length comes back from the decomposition
    via_cams = tcons.fuse_depth_maps(depths, images, cams, device="cpu")
    assert_same_cloud(got, via_cams)
    with pytest.raises(ValueError, match="exactly one"):
        tcons.fuse_depth_maps(depths, images, cams, P_matrices=P64, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tcons.fuse_depth_maps(depths, images, device="cpu")


@pytest.mark.parametrize("case", ["aligned", "rotated_rejected", "rotated_accepted",
                                  "fake_normals_holes"])
def test_normals_path_matches_jax(case):
    depths, images, cams = plane_scene(V=3)
    V, H, W = depths.shape
    normals = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), (V, H, W, 3)).copy()
    thresh = 10.0
    if case.startswith("rotated"):
        normals[1:] = np.array([0.0, np.sin(0.3), np.cos(0.3)], np.float32)
        thresh = np.rad2deg(0.2 if case == "rotated_rejected" else 0.5)
    elif case == "fake_normals_holes":
        depths = with_holes(depths, 0.4, 3)
        normals = np.stack([fake_normals(d) for d in depths])
        thresh = 30.0
    got, want = both(depths, images, cams, normals=normals, normal_thresh_deg=thresh)
    assert len(got) == len(want) == 3
    n = assert_same_cloud(got, want)
    assert (n == 0) == (case == "rotated_rejected")
    assert got[2].dtype == np.float32 and got[2].shape == got[0].shape


@pytest.mark.parametrize("ref_chunk", [1, 2, 3, 4, 64])
def test_ref_chunk_matches_jax_and_itself(ref_chunk):
    depths, images, cams = plane_scene(V=4, off_axis=True, seed=9)
    depths = with_holes(depths, 0.2, 11)
    got, want = both(depths, images, cams, ref_chunk=ref_chunk)
    assert assert_same_cloud(got, want) > 500
    one = tcons.fuse_depth_maps(depths, images, cams, ref_chunk=1, device="cpu")
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


@pytest.mark.parametrize("compact", ["never", "always", "auto"])
@pytest.mark.parametrize("drop", [0.0, 0.3, 0.8, 0.97])
def test_compact_matches_jax(compact, drop):
    depths, images, cams = plane_scene(V=4, off_axis=True, seed=12)
    depths = with_holes(depths, drop, 7) if drop else depths
    got, want = both(depths, images, cams, compact=compact)
    assert_same_cloud(got, want)


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("drop,hw", [(0.0, (20, 28)), (0.3, (20, 28)), (0.8, (20, 28)),
                                     (1.0, (20, 28)), (0.2, (120, 160))])
def test_sparse_equals_dense_exactly(drop, hw, normals):
    """Same points, same order, same bits: one function serves both paths' checks, and one
    host function emits both paths' points (at 120x160 a second back-projection, equal in
    exact arithmetic, rounds a few of ~90,000 points the other way)."""
    depths, images, cams = plane_scene(V=5, H=hw[0], W=hw[1], off_axis=True, seed=13)
    depths = with_holes(depths, drop, 17) if drop else depths
    kw = {}
    if normals:
        kw = dict(normals=np.stack([fake_normals(d) for d in depths]), normal_thresh_deg=30.0)
    dense = tcons.fuse_depth_maps(depths, images, cams, compact="never", device="cpu", **kw)
    for compact in ("always", "auto"):
        sparse = tcons.fuse_depth_maps(depths, images, cams, compact=compact, ref_chunk=2,
                                       device="cpu", **kw)
        assert len(sparse) == len(dense)
        for s, d in zip(sparse, dense):
            np.testing.assert_array_equal(s, d)
    assert dense[0].shape[0] == 0 if drop == 1.0 else (drop > 0.3 or dense[0].shape[0] > 100)


def test_auto_takes_the_sparse_path_when_it_is_smaller():
    depths, images, cams = plane_scene(V=3)
    stats = {}
    tcons.fuse_depth_maps(depths, images, cams, compact="auto", device="cpu", timings=stats)
    assert stats["chunks"] == 1 and stats["sparse_chunks"] == 0      # full maps: the grid
    tcons.fuse_depth_maps(with_holes(depths, 0.9, 0), images, cams, compact="auto",
                          ref_chunk=2, device="cpu", timings=stats)
    assert stats["chunks"] == 2 and stats["sparse_chunks"] == 2
    tcons.fuse_depth_maps(with_holes(depths, 0.9, 0), images, cams, compact="never",
                          device="cpu", timings=stats)
    assert stats["sparse_chunks"] == 0
    tcons.fuse_depth_maps(depths, images, cams, compact="always", device="cpu", timings=stats)
    assert stats["sparse_chunks"] == 1
    assert all(stats[k] >= 0.0 for k in ("upload_s", "wait_s", "compact_s"))
    with pytest.raises(ValueError, match="compact"):
        tcons.fuse_depth_maps(depths, images, cams, compact="sometimes", device="cpu")


def test_uint8_and_float32_images_identical():
    depths, images, cams = plane_scene(V=3, off_axis=True, seed=14)
    a = tcons.fuse_depth_maps(depths, images, cams, device="cpu")
    b = tcons.fuse_depth_maps(depths, images.astype(np.float32), cams, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_colour_cast_truncates_and_clamps():
    """Averaged colours are clamped to 0..255, then truncated (not rounded)."""
    depths, images, cams = plane_scene(V=3)
    img = np.full(images.shape, 300.0, np.float32)
    img[1] = -40.0
    img[2] = 100.6
    pts, cols = tcons.fuse_depth_maps(depths, img, cams, device="cpu")
    want = jcons.fuse_depth_maps(depths, img, cams)
    assert_same_cloud((pts, cols), want)
    assert cols.min() >= 0 and set(np.unique(cols)) <= set(np.unique(want[1]))


def test_bilinear_sampler_border_behaviour():
    """tex2D border: clamped coordinates, the far corner's weight exactly 0 at the edge;
    NaN and inf coordinates give a defined (discarded) read."""
    rng = np.random.RandomState(0)
    H, W = 5, 7
    maps = torch.from_numpy(rng.rand(2, H, W, 3).astype(np.float32))
    planes = tcons._planes(maps)
    assert planes.shape == (3, 2 * H * W) and planes.is_contiguous()
    x = torch.tensor([[[0.0, 6.0, 6.0, -3.0, 9.5, 2.5, float("nan"), float("inf")]] * 2])
    y = torch.tensor([[[0.0, 4.0, 1.5, 2.0, 7.0, 3.25, float("nan"), float("-inf")]] * 2])
    out = tcons._bilinear_sample_all_views(planes, x, y, H, W).permute(1, 2, 3, 0)
    assert out.shape == (1, 2, 8, 3) and bool(torch.isfinite(out).all())
    for v in range(2):
        torch.testing.assert_close(out[0, v, 0], maps[v, 0, 0])
        torch.testing.assert_close(out[0, v, 1], maps[v, 4, 6])
        torch.testing.assert_close(out[0, v, 2], 0.5 * (maps[v, 1, 6] + maps[v, 2, 6]))
        torch.testing.assert_close(out[0, v, 3], maps[v, 2, 0])
        torch.testing.assert_close(out[0, v, 4], maps[v, 4, 6])
        want = (0.75 * (0.5 * maps[v, 3, 2] + 0.5 * maps[v, 3, 3])
                + 0.25 * (0.5 * maps[v, 4, 2] + 0.5 * maps[v, 4, 3]))
        torch.testing.assert_close(out[0, v, 5], want)


@pytest.mark.parametrize("entry", ["cams", "P"])
def test_camera_geometry_equal(entry):
    _, _, cams = plane_scene(V=4, off_axis=True, seed=15)
    if entry == "cams":
        got, want = tcons.camera_geometry(cams), jcons.camera_geometry(cams)
    else:
        P64 = cams[:, 1, :3, :3].astype(np.float64) @ cams[:, 0, :3, :4].astype(np.float64)
        got, want = tcons.camera_geometry_from_P(P64), jcons.camera_geometry_from_P(P64)
        np.testing.assert_allclose(got[3], 40.0, rtol=1e-6)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_select_views_equal():
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1.0]])
    cams = np.stack([make_cam(K, rotation([0, 1, 0], np.deg2rad(a)), np.zeros(3))
                     for a in [0.0, 5.0, 15.0, 45.0, 25.0]])
    for ref in range(5):
        got = tcons.select_views(cams, ref, width=32, height=24, min_angle_deg=10,
                                 max_angle_deg=30)
        want = jcons.select_views(cams, ref, width=32, height=24, min_angle_deg=10,
                                  max_angle_deg=30)
        np.testing.assert_array_equal(got, want)
    assert list(tcons.select_views(cams, 0, 32, 24, 10, 30)) == [2, 4]


def test_default_device_is_cuda():
    depths, images, cams = plane_scene(V=3)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcons.fuse_depth_maps(depths, images, cams)
