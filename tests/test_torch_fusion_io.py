"""The port's numpy-only copies (fusion/ply, fusion/dmb, data/gipuma_io, data/colmap,
data/mvs_syn) against the originals, on the fixtures of tests/test_datasets.py,
tests/test_gipuma_io.py and tests/test_fusion.py. Files written by one package are read by
the other, both ways; everything is held to equality.
"""

import dataclasses
import filecmp
import json

import numpy as np
import pytest

from atvsnet_tpu.data import colmap as jcolmap
from atvsnet_tpu.data import gipuma_io as jgip
from atvsnet_tpu.data import mvs_syn as jsyn
from atvsnet_tpu.fusion import dmb as jdmb
from atvsnet_tpu.fusion import ply as jply
from atvsnet_torch.data import colmap as tcolmap
from atvsnet_torch.data import gipuma_io as tgip
from atvsnet_torch.data import mvs_syn as tsyn
from atvsnet_torch.data import preprocess as tpre
from atvsnet_torch.fusion import dmb as tdmb
from atvsnet_torch.fusion import ply as tply

from tests._utils import rotation
from tests.test_datasets import colmap_dir, mvs_syn_dir  # noqa: F401  (fixtures)
from tests.test_gipuma_io import _random_camera


# ---- fusion/ply, fusion/dmb ---------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 10, 300_000])
def test_ply_both_ways(tmp_path, n):
    rng = np.random.RandomState(n)
    pts = rng.rand(n, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    tply.write_ply(ours, pts, rgb)
    jply.write_ply(theirs, pts, rgb)
    assert filecmp.cmp(ours, theirs, shallow=False)
    for reader, path in ((jply.read_ply, ours), (tply.read_ply, theirs)):
        p2, c2 = reader(path)
        np.testing.assert_array_equal(p2, pts)
        np.testing.assert_array_equal(c2, rgb)


def test_ply_rejects_a_truncated_header(tmp_path):
    path = tmp_path / "cut.ply"
    path.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n")
    with pytest.raises(ValueError, match="end_header"):
        tply.read_ply(str(path))
    with pytest.raises(ValueError, match="must both be"):
        tply.write_ply(str(path), np.zeros((2, 3), np.float32), np.zeros((3, 3), np.uint8))


@pytest.mark.parametrize("shape", [(6, 9), (5, 7, 3), (4, 4, 1)])
def test_dmb_both_ways(tmp_path, shape):
    img = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    ours, theirs = str(tmp_path / "ours.dmb"), str(tmp_path / "theirs.dmb")
    tdmb.write_dmb(ours, img)
    jdmb.write_dmb(theirs, img)
    assert filecmp.cmp(ours, theirs, shallow=False)
    np.testing.assert_array_equal(jdmb.read_dmb(ours), img.squeeze())
    np.testing.assert_array_equal(tdmb.read_dmb(theirs), img.squeeze())


def test_p_matrix_and_fake_normals(tmp_path):
    K, R, t = _random_camera(3)
    P = K @ np.concatenate([R, t[:, None]], axis=1)
    ours, theirs = str(tmp_path / "ours.P"), str(tmp_path / "theirs.P")
    tdmb.write_p_matrix(ours, P)
    jdmb.write_p_matrix(theirs, P)
    assert filecmp.cmp(ours, theirs, shallow=False)
    np.testing.assert_array_equal(tdmb.read_p_matrix(theirs), jdmb.read_p_matrix(ours))
    np.testing.assert_allclose(tdmb.read_p_matrix(ours), P)
    d = np.array([[1.0, 0.0], [2.0, -3.0]], np.float32)
    np.testing.assert_array_equal(tdmb.fake_normals(d), jdmb.fake_normals(d))
    np.testing.assert_allclose(tdmb.fake_normals(d)[0, 0], 1 / np.sqrt(3), rtol=1e-5)
    assert (tdmb.fake_normals(d)[0, 1] == 0).all() and (tdmb.fake_normals(d)[1, 1] == 0).all()


# ---- data/gipuma_io ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("scale", [1.0, -3.5])
def test_decompose_projection(seed, scale):
    K, R, t = _random_camera(seed)
    P = scale * (K @ np.concatenate([R, t[:, None]], axis=1))
    got, want = tgip.decompose_projection(P), jgip.decompose_projection(P)
    for g, w, truth in zip(got, want, (K, R, t)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, truth, rtol=1e-9, atol=1e-8)
    with pytest.raises(ValueError):
        tgip.decompose_projection(np.eye(3))


def test_gipuma_readers(tmp_path):
    assert tgip.__all__ == jgip.__all__
    K, R, t = _random_camera(1)
    P0 = K @ np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    P1 = K @ np.concatenate([R, t[:, None]], axis=1)
    calib = tmp_path / "calib.txt"
    calib.write_text("\n".join(label + " " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                               for label, P in (("P0:", P0), ("P1:", P1))) + "\n")
    for g, w, truth in zip(tgip.read_kitti_calib(str(calib)), jgip.read_kitti_calib(str(calib)),
                           (P0, P1)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, truth, rtol=1e-10)

    pfile = tmp_path / "0000.txt"
    pfile.write_text("CONTOUR\n" + "\n".join(" ".join(f"{v:.12e}" for v in row) for row in P1)
                     + "\n")
    np.testing.assert_array_equal(tgip.read_pmvs_p_file(str(pfile)),
                                  jgip.read_pmvs_p_file(str(pfile)))
    pfile.write_text("1 2 3 4\n")
    with pytest.raises(ValueError, match="3 projection rows"):
        tgip.read_pmvs_p_file(str(pfile))

    camera = tmp_path / "img.camera"
    camera.write_text("2759.48 0 1520.69\n0 2764.16 1006.81\n0 0 1\n")
    assert tgip.read_strecha_camera(str(camera)) == jgip.read_strecha_camera(str(camera)) == 2759.48

    names, lines = ["a.png", "b.png"], ["2"]
    for i, n in enumerate(names):
        K, R, t = _random_camera(10 + i)
        lines.append(n + " " + " ".join(f"{v:.12e}" for v in
                                        np.concatenate([K.reshape(-1), R.reshape(-1), t])))
    krt = tmp_path / "krt.txt"
    krt.write_text("\n".join(lines) + "\n")
    np.testing.assert_array_equal(tgip.read_middlebury_krt(str(krt), names[::-1]),
                                  jgip.read_middlebury_krt(str(krt), names[::-1]))
    with pytest.raises(KeyError):
        tgip.read_middlebury_krt(str(krt), ["missing.png"])


# ---- data/colmap ---------------------------------------------------------------------------


def _same_fields(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        if isinstance(da[k], np.ndarray):
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            assert da[k] == db[k], k


def test_quaternion_to_rotation():
    rng = np.random.RandomState(0)
    for _ in range(5):
        q = rng.randn(4)
        np.testing.assert_array_equal(tcolmap.quaternion_to_rotation(*q),
                                      jcolmap.quaternion_to_rotation(*q))
    np.testing.assert_allclose(tcolmap.quaternion_to_rotation(1, 0, 0, 0), np.eye(3), atol=1e-12)


@pytest.mark.parametrize("with_points", [True, False])
@pytest.mark.parametrize("num_neighbors", [2, 9])
def test_colmap_sparse(colmap_dir, with_points, num_neighbors):  # noqa: F811
    got = tcolmap.ColmapSparse(*colmap_dir, num_neighbors=num_neighbors, with_points=with_points)
    want = jcolmap.ColmapSparse(*colmap_dir, num_neighbors=num_neighbors, with_points=with_points)
    assert got.cameras.keys() == want.cameras.keys() and len(got.images) == 4
    for k in want.cameras:
        _same_fields(got.cameras[k], want.cameras[k])
    for k in want.images:
        _same_fields(got.images[k], want.images[k])
        assert got.images[k].filepath == want.images[k].filepath
    assert got.points.keys() == want.points.keys() and len(got.points) == (60 if with_points else 0)
    for k in want.points:
        np.testing.assert_array_equal(got.points[k], want.points[k])
    for img_id in want.images:
        for inverse in (True, False):
            np.testing.assert_array_equal(
                tcolmap.colmap_cam_to_mvsnet(got, img_id, max_d=32, inverse_depth=inverse),
                jcolmap.colmap_cam_to_mvsnet(want, img_id, max_d=32, inverse_depth=inverse))
        assert (tcolmap.colmap_sample_paths(got, img_id, 3)
                == jcolmap.colmap_sample_paths(want, img_id, 3))
    if with_points:
        assert got.images[1].estimated_min_disparity < got.images[1].estimated_max_disparity


def test_set_depth_range_from_depthmap():
    cams = np.zeros((2, 2, 4, 4))
    depth = np.linspace(1.0, 9.0, 100).reshape(10, 10)
    depth[0, :3] = (0.0, 1e11, -2.0)
    got = tcolmap.set_depth_range_from_depthmap(cams, depth, max_d=32, interval_scale=0.8)
    np.testing.assert_array_equal(
        got, jcolmap.set_depth_range_from_depthmap(cams, depth, max_d=32, interval_scale=0.8))
    assert got[0][1, 3, 1] > 0 and (cams == 0).all()


# ---- data/mvs_syn --------------------------------------------------------------------------


def _same_dataset(got, want):
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        _same_fields(a, b)
        np.testing.assert_array_equal(a.view_vec, b.view_vec)
        np.testing.assert_array_equal(a.to_mvsnet_cam(16), b.to_mvsnet_cam(16))
    assert got.by_seq == want.by_seq
    for view_num in (2, 3):
        assert list(got.samples(view_num)) == list(want.samples(view_num))


@pytest.mark.parametrize("kw", [dict(num_neighbors=2, max_neighbor_range=4, seed=0),
                                dict(num_neighbors=2, seed=3),
                                dict(num_neighbors=3, max_neighbor_range=3, seed=1),
                                dict(num_neighbors=9, seed=0)])
def test_mvs_syn_dataset(mvs_syn_dir, kw):  # noqa: F811
    got, want = tsyn.MvsSynDataset(mvs_syn_dir, **kw), jsyn.MvsSynDataset(mvs_syn_dir, **kw)
    _same_dataset(got, want)
    assert len(got.images) == 10
    assert tsyn.DEMON_TRAIN_SETS == jsyn.DEMON_TRAIN_SETS
    if kw["num_neighbors"] == 2:
        assert list(got.samples(3))


def test_mvs_syn_angle_fallback_and_split(tmp_path):
    root = tmp_path / "syn"
    (root / "0000" / "poses").mkdir(parents=True)
    (root / "0001" / "poses").mkdir(parents=True)
    (root / "num_images.json").write_text(json.dumps([12, 12, 1]))
    (root / "val.json").write_text(json.dumps([1]))
    for s in range(2):
        for i in range(12):
            E = np.eye(4)
            E[:3, :3] = rotation([0, 1, 0], 0.01 * i)
            E[:3, 3] = [0.05 * i, 0, 0]
            (root / f"{s:04d}" / "poses" / f"{i:04d}.json").write_text(json.dumps(
                {"extrinsic": E.tolist(), "f_x": 50.0, "f_y": 50.0, "c_x": 32.0, "c_y": 24.0}))
    kw = dict(num_neighbors=2, max_neighbor_range=4, seed=0)
    got, want = tsyn.MvsSynDataset(str(root), **kw), jsyn.MvsSynDataset(str(root), **kw)
    _same_dataset(got, want)
    ref = got.images[got.by_seq[(0, 10)]]
    assert {got.images[i].img_id for p in ref.neighbor_permutations for i in p} <= {7, 8, 9, 11}
    for mode in ("training", "validation"):
        ours = list(got.training_samples(3, mode=mode, augment_number=2))
        assert ours == list(want.training_samples(3, mode=mode, augment_number=2)) and ours
        assert {got.images[ids[0]].seq_id for ids, _ in ours} == {0 if mode == "training" else 1}


def test_exr_reader_raises_ioerror_naming_the_path(tmp_path):
    """The EXR branch goes through data.image_io; where this OpenCV build can write EXR, a
    written map also reads back."""
    bad = tmp_path / "garbage.exr"
    bad.write_bytes(b"not an exr at all")
    for reader in (tsyn._read_exr_depth, tpre.read_gt_depth):
        with pytest.raises(IOError, match="garbage.exr"):
            reader(str(bad))
        with pytest.raises(IOError, match="absent.exr"):
            reader(str(tmp_path / "absent.exr"))
    import cv2

    depth = (1.0 + np.random.RandomState(0).rand(6, 8)).astype(np.float32)
    try:
        written = cv2.imwrite(str(tmp_path / "depth.exr"), depth)
    except cv2.error:
        written = False
    if written:
        got = tsyn._read_exr_depth(str(tmp_path / "depth.exr"))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, depth)
    # the training batch reader came with the training slice; tests/test_torch_train_data.py
    # holds it against the JAX package
    assert callable(tsyn.load_training_sample)
