"""The port's eval script and scene fusion against the JAX package's, on the CPU.

Four fabricated ETH3D-format scenes (3 images each, D=8, one 96x128 bucket) go through both
run_eval_pc with the same saved parameters (the port's seeded random weights), in ONE run
of each package:
  planes   96x128, written by the port's write_eth3d_scene (tools/make_planes_eth3d.make_scene
           writes the same bytes)
  small    64x96: smaller than the bucket, padded and cropped back
  mixed    one image 120x160 among 96x128 ones (center-cropped, principal point shifted)
  gt       with .pfm ground truth beside the images, which --gt_range reads

Tolerance: .jpg and .txt outputs equal byte for byte; metric depth PFMs rtol 1e-5, atol 1e-4;
confidence PFMs atol 1e-4 where the depth index is at least 1e-3 away from an integer
(probability_map is discontinuous there). Then both fuse_scene on the tree the JAX script
wrote, to the fusion tolerance of tests/test_torch_fusion.py: that holds the fusion apart
from the forward's noise.
"""

import filecmp
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from atvsnet_tpu.cli.eval_pointcloud import run_eval_pc as jax_run_eval_pc
from atvsnet_tpu.fusion.fuse import fuse_scene as jax_fuse_scene
from atvsnet_torch.cli import depth_fusion, eval_pointcloud, reproduce_pc
from atvsnet_torch.cli.eval_pointcloud import ETH3D_SCENES, run_eval_pc
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data import image_io
from atvsnet_torch.data.cams import load_cam, write_cam
from atvsnet_torch.data.pfm import load_pfm, save_pfm
from atvsnet_torch.data.synthetic import write_eth3d_scene
from atvsnet_torch.fusion.dmb import read_dmb, read_p_matrix
from atvsnet_torch.fusion.fuse import export_gipuma, fuse_scene, load_scene, probability_filter
from atvsnet_torch.fusion.ply import read_ply
from atvsnet_torch.params import init_model, save_params

from tests.test_torch_fusion import assert_same_cloud

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_planes_eth3d import make_scene  # noqa: E402

torch.set_num_threads(2)

VIEW_NUM, H, W, D = 3, 96, 128, 8
SCENES = ["planes", "small", "mixed", "gt"]
KW = dict(view_num=VIEW_NUM, max_d=D, max_w=W, max_h=H, gt_range=True)
DEPTH_TOL = dict(rtol=1e-5, atol=1e-4)


def _tree(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, files in os.walk(folder) for f in files)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    eth3d = root / "eth3d"
    write_eth3d_scene(str(eth3d / "planes"), 3, H, W, seed=0, num_d=D, num_spheres=1)
    write_eth3d_scene(str(eth3d / "small"), 3, 64, 96, seed=1, num_d=D)
    write_eth3d_scene(str(eth3d / "mixed"), 3, H, W, seed=2, num_d=D)
    # image 1 of "mixed" grows to 120x160 by edge replication; its principal point moves
    # with it, so the center crop back to the bucket restores both
    img_path = str(eth3d / "mixed" / "images" / "00000001.jpg")
    cam_path = str(eth3d / "mixed" / "cams" / "00000001_cam.txt")
    image_io.imwrite(img_path, np.pad(image_io.imread(img_path), ((12, 12), (16, 16), (0, 0)),
                                      mode="edge"), jpeg_quality=98)
    cam = load_cam(cam_path, max_d=D)
    cam[1, 0, 2] += 16
    cam[1, 1, 2] += 12
    write_cam(cam_path, cam)
    write_eth3d_scene(str(eth3d / "gt"), 3, H, W, seed=3, num_d=D, num_spheres=1)
    os.makedirs(eth3d / "gt" / "depths")
    for v in (0, 2):                       # image 1 has no ground truth: its range stays
        (eth3d / "gt" / "images" / f"{v:08d}.txt").write_text(f"{v:08d}.jpg\n")
        shutil.copy(eth3d / "gt" / "gt_depths" / f"{v:08d}.pfm",
                    eth3d / "gt" / "depths" / f"{v:08d}.pfm")
    return str(root)


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "random.npz")
    save_params(path, init_model(PipelineConfig(view_num=VIEW_NUM, max_d=D, max_h=H, max_w=W),
                                 seed=4, device="cpu"))
    return path


@pytest.fixture(scope="module")
def outputs(data_root, params_path, tmp_path_factory):
    """(the port's savepath, the JAX package's savepath, the port's returned clock)."""
    out = tmp_path_factory.mktemp("out")
    port, jax_out = str(out / "port"), str(out / "jax")
    stats = run_eval_pc(data_root, port, SCENES, params_path=params_path, device="cpu", **KW)
    jax_run_eval_pc(data_root, jax_out, SCENES, params_path=params_path, **KW)
    return port, jax_out, stats


def test_write_eth3d_scene_equals_the_tool(data_root, tmp_path):
    make_scene(str(tmp_path / "tool"), 3, H, W, 0, num_d=D, num_spheres=1)
    ours = os.path.join(data_root, "eth3d", "planes")
    files = _tree(str(tmp_path / "tool"))
    assert files == _tree(ours) and len(files) == 3 * 3 + 1
    assert "pair.txt" in files and "gt_depths/00000002.pfm" in files
    for f in files:
        assert filecmp.cmp(os.path.join(ours, f), os.path.join(tmp_path / "tool", f),
                           shallow=False), f
    gt = load_pfm(os.path.join(ours, "gt_depths", "00000000.pfm"))
    assert gt.shape == (H, W) and 1.0 <= gt.min() and gt.max() <= 2.0


@pytest.mark.parametrize("scene", SCENES)
def test_same_files_as_jax(outputs, scene):
    port, jax_out, _ = outputs
    ours, theirs = (os.path.join(p, scene, "depths_atvsnet") for p in (port, jax_out))
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == files
    assert files == sorted(f"{v:08d}{s}" for v in range(3)
                           for s in (".jpg", ".pfm", ".png", ".txt", "_prob.pfm"))
    for f in files:
        if f.endswith((".jpg", ".txt")):
            assert filecmp.cmp(os.path.join(ours, f), os.path.join(theirs, f), shallow=False), f
    for p in (port, jax_out):
        with open(os.path.join(p, scene, "zz_runtime.txt")) as f:
            assert f.read().startswith("runtime ")


def _sweep_index(depth, cam_path):
    cam = load_cam(cam_path)
    start, interval = cam[1, 3, 0], cam[1, 3, 1]
    return (1.0 / np.maximum(depth, 1e-6) - start) / interval


@pytest.mark.parametrize("scene", SCENES)
def test_depth_and_confidence_match_jax(outputs, scene):
    port, jax_out, _ = outputs
    ours, theirs = (os.path.join(p, scene, "depths_atvsnet") for p in (port, jax_out))
    shape = (16, 24) if scene == "small" else (H // 4, W // 4)
    for v in range(3):
        got, want = (load_pfm(os.path.join(p, f"{v:08d}.pfm")) for p in (ours, theirs))
        assert got.shape == want.shape == shape and got.dtype == np.float32
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **DEPTH_TOL, err_msg=f"{scene} {v}")
        conf, conf_want = (load_pfm(os.path.join(p, f"{v:08d}_prob.pfm")) for p in (ours, theirs))
        idx = _sweep_index(want, os.path.join(theirs, f"{v:08d}.txt"))
        away = np.abs(idx - np.round(idx)) > 1e-3
        assert away.mean() > 0.9
        np.testing.assert_allclose(conf[away], conf_want[away], rtol=0, atol=1e-4)


def test_gt_range_narrows_the_sweep(outputs, data_root):
    """With a .pfm ground truth beside the image the sweep is the ground truth's range, so
    the metric depths (convex combinations of sweep values) lie inside it; image 1 has none
    and keeps the cam file's range."""
    port = outputs[0]
    folder = os.path.join(port, "gt", "depths_atvsnet")
    for v in (0, 2):
        gt = load_pfm(os.path.join(data_root, "eth3d", "gt", "depths", f"{v:08d}.pfm"))
        depth = load_pfm(os.path.join(folder, f"{v:08d}.pfm"))
        assert depth.min() >= gt.min() - 1e-3 and depth.max() <= gt.max() + 1e-3
        row = load_cam(os.path.join(folder, f"{v:08d}.txt"))[1, 3]
        np.testing.assert_allclose([row[0], row[3]], [1.0 / gt.max(), 1.0 / gt.min()], rtol=1e-5)
    row = load_cam(os.path.join(folder, "00000001.txt"))[1, 3]
    np.testing.assert_allclose([row[0], row[3]], [0.5, 1.0], rtol=1e-6)


def test_returned_clock(outputs):
    stats = outputs[2]
    assert set(stats["scenes"]) == set(SCENES)
    assert all(s["ref_images"] == 3 and s["maps_per_s"] > 0 for s in stats["scenes"].values())
    assert len(stats["batch_seconds"]) == 12 and min(stats["batch_seconds"]) > 0
    assert set(stats["blocked"]) == {"load_s", "queue_forward_s", "wait_forward_s",
                                     "write_flush_s"}


def test_batch_2_equals_batch_1(outputs, data_root, params_path, tmp_path):
    """3 images: a chunk of 2 and a padded tail. On the CPU the batched pass is the single
    one to a few ulps."""
    run_eval_pc(data_root, str(tmp_path), ["planes"], params_path=params_path, batch=2,
                device="cpu", **KW)
    for v in range(3):
        for suffix in (".pfm", "_prob.pfm"):
            got, want = (load_pfm(os.path.join(p, "planes", "depths_atvsnet", f"{v:08d}{suffix}"))
                         for p in (str(tmp_path), outputs[0]))
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
        for suffix in (".jpg", ".txt"):
            assert filecmp.cmp(
                os.path.join(tmp_path, "planes", "depths_atvsnet", f"{v:08d}{suffix}"),
                os.path.join(outputs[0], "planes", "depths_atvsnet", f"{v:08d}{suffix}"),
                shallow=False)


def test_full_viz_and_random_weights(data_root, tmp_path):
    """full_viz renders the png from the 4x-upsampled map; without params_path the weights
    come from `seed`. A scene folder that is missing is skipped."""
    kw = dict(view_num=VIEW_NUM, max_d=D, max_w=W, max_h=H, device="cpu")
    run_eval_pc(data_root, str(tmp_path / "a"), ["planes", "no_such_scene"], full_viz=True,
                seed=1, **kw)
    run_eval_pc(data_root, str(tmp_path / "b"), ["planes"], seed=1, **kw)
    run_eval_pc(data_root, str(tmp_path / "c"), ["planes"], seed=2, **kw)
    assert os.listdir(tmp_path / "a") == ["planes"]
    a, b, c = (str(tmp_path / k / "planes" / "depths_atvsnet") for k in "abc")
    assert image_io.imread(os.path.join(a, "00000000.png")).shape == (H, W, 3)
    assert image_io.imread(os.path.join(b, "00000000.png")).shape == (H // 4, W // 4, 3)
    da, db, dc = (load_pfm(os.path.join(p, "00000000.pfm")) for p in (a, b, c))
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)
    assert np.abs(db - dc).max() > 1e-3


def _copy_tree_with_gt_depths(src_scene, dst_scene, data_root, scene):
    """A copy of an eval output tree whose depth maps are the scene's ground truth,
    nearest-downsampled to the cost-volume grid, with confidence 1 except in a corner."""
    shutil.copytree(src_scene, dst_scene)
    folder = os.path.join(dst_scene, "depths_atvsnet")
    for v in range(3):
        gt = load_pfm(os.path.join(data_root, "eth3d", scene, "gt_depths", f"{v:08d}.pfm"))
        save_pfm(os.path.join(folder, f"{v:08d}.pfm"), np.ascontiguousarray(gt[2::4, 2::4]))
        conf = np.ones((H // 4, W // 4), np.float32)
        conf[:5, :7] = 0.5
        save_pfm(os.path.join(folder, f"{v:08d}_prob.pfm"), conf)


@pytest.mark.parametrize("case", ["as_written_loose", "gt_depths_defaults"])
def test_fuse_scene_matches_jax_on_the_jax_tree(outputs, data_root, tmp_path, case):
    jax_scene = os.path.join(outputs[1], "planes")
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    if case == "as_written_loose":
        # random-weight depths are mostly inconsistent: no confidence filter and a loose
        # disparity threshold, so that points survive
        kw = dict(prob_threshold=0.0, disp_threshold=10.0, num_consistent=1)
        shutil.copytree(jax_scene, ours)
        shutil.copytree(jax_scene, theirs)
    else:
        kw = {}
        _copy_tree_with_gt_depths(jax_scene, ours, data_root, "planes")
        shutil.copytree(ours, theirs)
    ply = fuse_scene(ours, device="cpu", **kw)
    assert ply == os.path.join(ours, "final3d_model.ply")
    got, want = read_ply(ply), read_ply(jax_fuse_scene(theirs, **kw))
    assert assert_same_cloud(got, want) > 500
    # the filtered maps both packages wrote are equal
    for v in range(3):
        a, b = (load_pfm(os.path.join(p, "depths_atvsnet", f"{v:08d}_prob_filtered.pfm"))
                for p in (ours, theirs))
        np.testing.assert_array_equal(a, b)
        if case == "gt_depths_defaults":
            assert (a[:5, :7] == 0).all() and (a[5:, 7:] > 0).all()


def test_load_scene_and_export_gipuma_layout(outputs, tmp_path):
    dense = str(tmp_path / "planes")
    shutil.copytree(os.path.join(outputs[0], "planes"), dense)
    with pytest.raises(FileNotFoundError):
        load_scene(os.path.join(dense, "depths_atvsnet"), filtered=True)
    probability_filter(os.path.join(dense, "depths_atvsnet"), 0.0)
    depths, images, cams, names = load_scene(os.path.join(dense, "depths_atvsnet"))
    assert depths.shape == (3, H // 4, W // 4) and images.shape == (3, H // 4, W // 4, 3)
    assert images.dtype == np.uint8 and cams.shape == (3, 2, 4, 4) and cams.dtype == np.float32
    assert names == [f"{v:08d}" for v in range(3)]
    points = str(tmp_path / "points")
    export_gipuma(dense, points)
    for name in names:
        assert read_p_matrix(os.path.join(points, "cams", name + ".jpg.P")).shape == (3, 4)
        assert os.path.exists(os.path.join(points, "images", name + ".jpg"))
        disp = read_dmb(os.path.join(points, f"2333__{name}", "disp.dmb"))
        normals = read_dmb(os.path.join(points, f"2333__{name}", "normals.dmb"))
        assert disp.shape == (H // 4, W // 4) and normals.shape == (H // 4, W // 4, 3)
        np.testing.assert_array_equal(
            disp, load_pfm(os.path.join(dense, "depths_atvsnet", name + "_prob_filtered.pfm")))


def test_reproduce_pc_main(data_root, params_path, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "reproduce_pc", "--data_root", data_root, "--savepath", str(tmp_path),
        "--scenes", "planes", "absent", "--view_num", "3", "--max_d", "8", "--max_w", "128",
        "--max_h", "96", "--params", params_path, "--prob_threshold", "0.0",
        "--disp_threshold", "10.0", "--num_consistent", "1", "--device", "cpu"])
    reproduce_pc.main()
    points, colours = read_ply(str(tmp_path / "planes" / "final3d_model.ply"))
    assert points.shape[0] > 0 and colours.shape == points.shape
    assert not os.path.exists(tmp_path / "absent")


def test_depth_fusion_and_eval_pointcloud_main(outputs, data_root, params_path, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "eval_pointcloud", "--data_root", data_root, "--savepath", str(tmp_path),
        "--scenes", "small", "--view_num", "3", "--max_d", "8", "--max_w", "128",
        "--max_h", "96", "--params", params_path, "--device", "cpu"])
    eval_pointcloud.main()
    dense = str(tmp_path / "small")
    got = load_pfm(os.path.join(dense, "depths_atvsnet", "00000001.pfm"))
    want = load_pfm(os.path.join(outputs[0], "small", "depths_atvsnet", "00000001.pfm"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    out_ply = str(tmp_path / "cloud.ply")
    monkeypatch.setattr(sys, "argv", [
        "depth_fusion", "--dense_folder", dense, "--prob_threshold", "0.0",
        "--disp_threshold", "10.0", "--num_consistent", "1", "--out_ply", out_ply,
        "--device", "cpu"])
    depth_fusion.main()
    assert read_ply(out_ply)[0].shape[0] > 0


def test_entry_points_default_to_cuda(data_root, tmp_path):
    assert ETH3D_SCENES == ["lakeside", "sand_box", "storage_room", "storage_room_2", "tunnel"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval_pc(data_root, str(tmp_path), ["planes"], view_num=3, max_d=8, max_w=W, max_h=H)
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_scene(str(tmp_path))
    with pytest.raises(SystemExit, match="not found"):
        run_eval_pc(data_root, str(tmp_path), ["planes"], params_path="/nonexistent.npz",
                    device="cpu")
