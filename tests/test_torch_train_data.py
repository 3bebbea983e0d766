"""The port's training data against the JAX package's (CPU): the photometric augmentation,
MVS-Synth's load_training_sample and the ETH3D/COLMAP training samples.

Both packages get the same seeded numpy RandomState and the same fabricated files, and
must draw from it in the same order: the RandomState's next draw after each call is
compared too. Images are compared at atol 1e-5 (the two packages normalize with numpy's
and OpenCV's float64 statistics); cameras, depths and sample lists exactly. The EXR
reader is replaced in both packages by one function of the path, as
tests/test_datasets.py does: the CPU's OpenCV build has no EXR codec.
"""

import json
import os

import numpy as np
import pytest

import atvsnet_tpu.data.mvs_syn as jms
from atvsnet_tpu.data import augment as jaug
from atvsnet_tpu.data import colmap_train as jct
import atvsnet_torch.data.mvs_syn as tms
from atvsnet_torch.data import augment as taug
from atvsnet_torch.data import colmap_train as tct
from atvsnet_torch.data import image_io
from atvsnet_torch.data.pfm import load_pfm, save_pfm
from atvsnet_torch.data.synthetic import rotation

H, W = 48, 64


@pytest.mark.parametrize("color_shift", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_augment_group_matches_jax(color_shift, normalize):
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (H, W, 3)).astype(np.uint8) for _ in range(3)]
    ours, theirs = np.random.RandomState(7), np.random.RandomState(7)
    got = taug.augment_image_group(images, rng=ours, enable_color_shift=color_shift,
                                   normalize_image=normalize)
    ref = jaug.augment_image_group(images, rng=theirs, enable_color_shift=color_shift,
                                   normalize_image=normalize)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert ours.rand() == theirs.rand()
    # rng=None: the identity jitter, then the normalization alone
    for a, b in zip(taug.augment_image_group(images), jaug.augment_image_group(images)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_augment_color_saturates_like_jax():
    img = np.full((4, 4, 3), 255, np.uint8)
    for kw in (dict(random_brightness=3.0, normalize_image=False),
               dict(random_gamma=1.1, random_color_image=np.full((4, 4), 0.05))):
        np.testing.assert_allclose(taug.augment_image_color(img, **kw),
                                   jaug.augment_image_color(img, **kw), atol=1e-6)


@pytest.fixture(scope="module")
def mvs_syn_dir(tmp_path_factory):
    """Two sequences of 5 frames: seq 0 with neighbor and score files, seq 1 without (the
    angle fallback); images as PNG."""
    root = tmp_path_factory.mktemp("mvs_syn")
    rng = np.random.RandomState(0)
    with open(root / "num_images.json", "w") as f:
        json.dump([5, 5], f)
    for s in range(2):
        seq = root / f"{s:04d}"
        for sub in ("poses", "images", "neighbors"):
            (seq / sub).mkdir(parents=True)
        for i in range(5):
            E = np.eye(4)
            E[:3, :3] = rotation([0, 1, 0], 0.02 * i)
            E[:3, 3] = [0.1 * i, 0.01 * i, 0]
            with open(seq / "poses" / f"{i:04d}.json", "w") as f:
                json.dump({"extrinsic": E.tolist(), "f_x": 50.0, "f_y": 50.0, "c_x": 32.0,
                           "c_y": 24.0}, f)
            image_io.imwrite(str(seq / "images" / f"{i:04d}.png"),
                             rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
            if s == 0:
                with open(seq / "neighbors" / f"{i:04d}.json", "w") as f:
                    json.dump([j for j in range(5) if j != i], f)
                with open(seq / "neighbors" / f"{i:04d}_score.json", "w") as f:
                    json.dump([[0.9, 0.7, 0.5, 0.3], 0.8], f)
    return str(root)


def _depth_of(path):
    """A deterministic depth map per file: 2-3 m with a band of invalid (inf) pixels."""
    rng = np.random.RandomState(sum(map(ord, path)) % 2**31)
    d = (2.0 + rng.rand(H, W)).astype(np.float32)
    d[:3] = np.inf
    return d


@pytest.mark.parametrize("multi_depth", [False, True])
def test_load_training_sample_matches_jax(mvs_syn_dir, monkeypatch, multi_depth):
    monkeypatch.setattr(jms, "_read_exr_depth", _depth_of)
    monkeypatch.setattr(tms, "_read_exr_depth", _depth_of)
    ds_j = jms.MvsSynDataset(mvs_syn_dir, num_neighbors=2, max_neighbor_range=4, seed=0)
    ds_t = tms.MvsSynDataset(mvs_syn_dir, num_neighbors=2, max_neighbor_range=4, seed=0)
    samples = list(ds_t.training_samples(3))
    assert samples == list(ds_j.training_samples(3)) and len(samples) > 4
    for ids, _ in samples[::3]:
        ours, theirs = np.random.RandomState(3), np.random.RandomState(3)
        got = tms.load_training_sample(ds_t, ids, max_d=8, augment_rng=ours, multi_depth=multi_depth)
        ref = jms.load_training_sample(ds_j, ids, max_d=8, augment_rng=theirs, multi_depth=multi_depth)
        assert got.keys() == ref.keys()
        assert ("depth_views_gt" in got) == multi_depth
        np.testing.assert_allclose(got["images"], ref["images"], atol=1e-5)
        for k in got.keys() - {"images"}:
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert ours.rand() == theirs.rand()
    assert got["depth_gt"].shape == (1, H // 4, W // 4, 1) and got["cams"][0, 0, 1, 3, 1] > 0


def test_load_training_sample_rejects_an_empty_depth_map(mvs_syn_dir, monkeypatch):
    monkeypatch.setattr(tms, "_read_exr_depth", lambda path: np.zeros((H, W), np.float32))
    ds = tms.MvsSynDataset(mvs_syn_dir, num_neighbors=2, max_neighbor_range=4, seed=0)
    ids, _ = next(ds.training_samples(3))
    with pytest.raises(ValueError, match="no valid GT depth"):
        tms.load_training_sample(ds, ids, max_d=8)


@pytest.fixture(scope="module")
def eth3d_dir(tmp_path_factory):
    """One ETH3D scene: a COLMAP text model, 4 images, raw-float32 gt depths with NaN rows."""
    data_root = tmp_path_factory.mktemp("eth3d_data")
    gt_root = tmp_path_factory.mktemp("eth3d_gt")
    scene = "delivery_area"
    sparse = data_root / scene / "rig_calibration"
    images_dir = data_root / scene / "images_undistorted"
    depth_dir = gt_root / f"{scene}_rig_depth" / scene / "ground_truth_depth_undistorted"
    for d in (sparse, images_dir, depth_dir):
        d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    n_img, n_pts = 4, 60
    pts = np.concatenate([rng.uniform(-1, 1, (n_pts, 2)), rng.uniform(4, 6, (n_pts, 1))], axis=1)
    with open(sparse / "cameras.txt", "w") as f:
        f.write("# Camera list\n1 PINHOLE 64 48 50 50 32 24\n")
    lines = ["# Image list\n"]
    for i in range(n_img):
        qw, qy = np.cos(0.025 * i), -np.sin(0.025 * i)
        lines.append(f"{i + 1} {qw} 0.0 {qy} 0.0 {0.2 * i} 0.0 0.0 1 img{i}.png\n")
        lines.append(" ".join(f"{10.0 + j} {12.0 + j} {j + 1}" for j in range(i * 5, i * 5 + 40)) + "\n")
    with open(sparse / "images.txt", "w") as f:
        f.writelines(lines)
    with open(sparse / "points3D.txt", "w") as f:
        for j in range(n_pts):
            f.write(f"{j + 1} {pts[j, 0]} {pts[j, 1]} {pts[j, 2]} 128 128 128 0.5\n")
    for i in range(n_img):
        image_io.imwrite(str(images_dir / f"img{i}.png"), rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
        depth = (4.0 + rng.rand(H, W)).astype(np.float32)
        depth[:4] = np.nan
        depth.tofile(str(depth_dir / f"img{i}.png"))
    return str(data_root), str(gt_root)


def _sample_fields(samples):
    return [(s.scene_idx, s.ref_id, tuple(s.view_ids), s.gt_depth_path, s.augment_index)
            for s in samples]


def test_eth3d_samples_and_neighbors_match_jax(eth3d_dir):
    data_root, gt_root = eth3d_dir
    kw = dict(view_num=3, augment_number=2, scenes=["delivery_area"])
    got, sparses_t = tct.eth3d_training_samples(data_root, gt_root, **kw)
    ref, sparses_j = jct.eth3d_training_samples(data_root, gt_root, **kw)
    assert _sample_fields(got) == _sample_fields(ref) and len(got) == 8
    for ref_id in sparses_t[0].images:
        for view_num in (2, 3, 6):
            assert (tct.eth3d_neighbor_ids(sparses_t[0], ref_id, view_num)
                    == jct.eth3d_neighbor_ids(sparses_j[0], ref_id, view_num))
    # the fallback when no image shares points with the reference
    sparses_t[0].images[1].neighbor_list, sparses_j[0].images[1].neighbor_list = [], []
    assert tct.eth3d_neighbor_ids(sparses_t[0], 1, 4) == jct.eth3d_neighbor_ids(sparses_j[0], 1, 4)
    assert tct.eth3d_training_samples(data_root, gt_root, 3, mode="validation") == ([], [])


def test_load_gt_depth_matches_jax(eth3d_dir, tmp_path):
    data_root, gt_root = eth3d_dir
    samples, _ = tct.eth3d_training_samples(data_root, gt_root, 3, scenes=["delivery_area"])
    raw = samples[0].gt_depth_path
    got, ref = tct.load_gt_depth(raw, H, W), jct.load_gt_depth(raw, H, W)
    np.testing.assert_array_equal(got, ref)
    assert (got[:4] == 0).all() and (got[4:] > 0).all()
    pfm = str(tmp_path / "d.pfm")
    save_pfm(pfm, np.where(np.isfinite(got), got, np.inf).astype(np.float32))
    np.testing.assert_array_equal(tct.load_gt_depth(pfm, H, W), jct.load_gt_depth(pfm, H, W))
    with pytest.raises(ValueError, match="expected"):
        tct.load_gt_depth(raw, H + 1, W)


@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_load_colmap_training_sample_matches_jax(eth3d_dir, scale):
    data_root, gt_root = eth3d_dir
    got_s, sparses_t = tct.eth3d_training_samples(data_root, gt_root, 3, scenes=["delivery_area"])
    _, sparses_j = jct.eth3d_training_samples(data_root, gt_root, 3, scenes=["delivery_area"])
    for s in got_s[:2]:
        ours, theirs = np.random.RandomState(5), np.random.RandomState(5)
        kw = dict(max_d=8, max_h=32, max_w=32, scale=scale)
        got = tct.load_colmap_training_sample(sparses_t[0], s.ref_id, s.view_ids, s.gt_depth_path,
                                              augment_rng=ours, **kw)
        ref = jct.load_colmap_training_sample(sparses_j[0], s.ref_id, s.view_ids, s.gt_depth_path,
                                              augment_rng=theirs, **kw)
        np.testing.assert_allclose(got["images"], ref["images"], atol=1e-5)
        np.testing.assert_array_equal(got["cams"], ref["cams"])
        np.testing.assert_array_equal(got["depth_gt"], ref["depth_gt"])
        assert ours.rand() == theirs.rand()


def test_emit_training_samples_matches_jax(eth3d_dir, tmp_path):
    data_root, gt_root = eth3d_dir
    samples, sparses_t = tct.eth3d_training_samples(data_root, gt_root, 3, scenes=["delivery_area"])
    _, sparses_j = jct.eth3d_training_samples(data_root, gt_root, 3, scenes=["delivery_area"])
    kw = dict(max_d=8, max_h=32, max_w=32)
    n_t = tct.emit_training_samples(samples, sparses_t, str(tmp_path / "port"), **kw)
    n_j = jct.emit_training_samples(samples, sparses_j, str(tmp_path / "jax"), **kw)
    assert n_t == n_j == len(samples)
    for idx in range(n_t):
        a, b = tmp_path / "port" / f"{idx:08d}", tmp_path / "jax" / f"{idx:08d}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in os.listdir(a):
            if name.endswith(".txt"):
                assert (a / name).read_text() == (b / name).read_text()
            elif name.endswith(".pfm"):
                np.testing.assert_array_equal(load_pfm(str(a / name)), load_pfm(str(b / name)))
            else:
                np.testing.assert_array_equal(image_io.imread(str(a / name)), image_io.imread(str(b / name)))
