"""The port's host-side modules against their atvsnet_tpu originals: cameras, PFM and cam
files, pair lists, the preparation policy, the error metrics and their report writers.

Both sides get the same seeded numpy arrays and the same temp files. Everything is
integer or float64/float32 numpy on the host, so results are required to be EQUAL, with
one exception: center_image, where the port takes its moments with numpy in float64 and
the original with cv2.meanStdDev (atol 1e-6 on values of order 1).
"""

import json
import os
import sys
import zipfile

import cv2
import numpy as np
import pytest

from atvsnet_tpu.cli import eval_errors as jcli_errors
from atvsnet_tpu.data import cams as jcams
from atvsnet_tpu.data import mvs_list as jlist
from atvsnet_tpu.data import pfm as jpfm
from atvsnet_tpu.data import preprocess as jpre
from atvsnet_tpu.eval import errors as jerr
from atvsnet_tpu.geometry.cameras import scale_camera_np as jscale_camera
from atvsnet_tpu.utils import log as jlog
from atvsnet_tpu.utils import xlsx as jxlsx
from atvsnet_torch.cli import eval_errors as tcli_errors
from atvsnet_torch.data import cams as tcams
from atvsnet_torch.data import image_io
from atvsnet_torch.data import mvs_list as tlist
from atvsnet_torch.data import pfm as tpfm
from atvsnet_torch.data import preprocess as tpre
from atvsnet_torch.eval import errors as terr
from atvsnet_torch.geometry.cameras import scale_camera_np
from atvsnet_torch.utils import log as tlog
from atvsnet_torch.utils import xlsx as txlsx


def _cam(rng, h, w, depth_row=(0.5, 0.01, 0.0, 0.0)):
    cam = np.zeros((2, 4, 4), np.float64)
    cam[0] = np.eye(4)
    cam[0, :3, 3] = rng.randn(3) * 0.1
    cam[1, :3, :3] = [[w * 1.1, 0, w / 2 + 0.3], [0, w * 1.2, h / 2 - 0.7], [0, 0, 1]]
    cam[1, 3] = depth_row
    return cam


def _frames(rng, sizes, dtype=np.uint8):
    return [rng.randint(0, 255, size=(h, w, 3)).astype(dtype) for h, w in sizes]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _equal_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---- cameras, PFM, cam files, pair lists ------------------------------------------


@pytest.mark.parametrize("scale", [0.25, 0.5, 1.0, 1.7])
def test_scale_camera_np(scale):
    cam = _cam(np.random.RandomState(0), 48, 64).astype(np.float32)
    got, ref = scale_camera_np(cam, scale), jscale_camera(cam, scale)
    np.testing.assert_array_equal(got, ref)
    assert got is not cam and got.dtype == ref.dtype


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (4, 6, 3)])
def test_pfm_roundtrip_byte_for_byte(tmp_path, shape):
    img = np.random.RandomState(1).randn(*shape).astype(np.float32)
    pt, pj = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    tpfm.save_pfm(pt, img, scale=2.0)
    jpfm.save_pfm(pj, img, scale=2.0)
    assert _read(pt) == _read(pj)
    got = tpfm.load_pfm(pj)
    np.testing.assert_array_equal(got, jpfm.load_pfm(pt))
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    with open(pt, "rb") as f:       # an open file works as well as a path
        np.testing.assert_array_equal(tpfm.load_pfm(f), got)


def test_pfm_rejects_other_files(tmp_path):
    p = tmp_path / "x.pfm"
    p.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError, match="Not a PFM"):
        tpfm.load_pfm(str(p))
    with pytest.raises(ValueError):
        tpfm.save_pfm(str(p), np.zeros((2, 2, 2), np.float32))


def test_cam_file_roundtrip_byte_for_byte(tmp_path):
    cam = _cam(np.random.RandomState(2), 48, 64, (0.5, 0.0125, 64.0, 1.3))
    pt, pj = str(tmp_path / "t_cam.txt"), str(tmp_path / "j_cam.txt")
    tcams.write_cam(pt, cam)
    jcams.write_cam(pj, cam)
    assert _read(pt) == _read(pj)
    got = tcams.load_cam(pj, interval_scale=1.5, max_d=32)
    np.testing.assert_array_equal(got, jcams.load_cam(pt, interval_scale=1.5, max_d=32))
    np.testing.assert_array_equal(got[0], cam[0])
    np.testing.assert_array_equal(tcams.projection_matrix(cam), jcams.projection_matrix(cam))


@pytest.mark.parametrize("depth_words", [2, 3, 4])
def test_load_cam_text_depth_row_variants(depth_words):
    rng = np.random.RandomState(3)
    words = ["extrinsic"] + [repr(float(x)) for x in rng.randn(16)]
    words += ["intrinsic"] + [repr(float(x)) for x in rng.rand(9)]
    words += ["0.4", "0.02", "48", "2.0"][:depth_words]
    text = " ".join(words)
    got = tcams.load_cam_text(text, interval_scale=2.0, max_d=96)
    np.testing.assert_array_equal(got, jcams.load_cam_text(text, interval_scale=2.0, max_d=96))
    assert got[1, 3, 2] == (96 if depth_words == 2 else 48)


@pytest.mark.parametrize("view_num", [2, 3, 5])
def test_gen_pipeline_mvs_list(tmp_path, view_num):
    (tmp_path / "pair.txt").write_text(
        "3\n0\n3 1 2.5 2 1.5 3 0.5\n1\n2 0 3.0 2 1.0\n7\n4 0 1 1 1 2 1 3 1\n")
    got = tlist.gen_pipeline_mvs_list(str(tmp_path), view_num)
    assert got == jlist.gen_pipeline_mvs_list(str(tmp_path), view_num)
    assert [len(p) for p in got] == [2 * min(view_num, n + 1) for n in (3, 2, 4)]
    assert got[2][0].endswith(os.path.join("images", "00000007.jpg"))


# ---- the image codec module --------------------------------------------------------


def test_image_io_matches_cv2(tmp_path):
    img = _frames(np.random.RandomState(4), [(20, 30)])[0]
    path = str(tmp_path / "a.png")
    image_io.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    for inter, flag in (("linear", cv2.INTER_LINEAR), ("nearest", cv2.INTER_NEAREST)):
        np.testing.assert_array_equal(
            image_io.resize(img, 0.5, inter), cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=flag))
    cm = image_io.colormap(np.linspace(0.0, 3.0, 12, dtype=np.float32).reshape(3, 4))
    assert cm.shape == (3, 4, 3) and cm.dtype == np.uint8 and (cm[0, 0] != cm[-1, -1]).any()
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.jpg"))


def test_image_io_names_the_missing_library(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)      # makes `import cv2` raise ImportError
    for call in (lambda: image_io.imread("x.jpg"), lambda: image_io.resize(np.zeros((4, 4, 3)), 0.5),
                 lambda: image_io.colormap(np.zeros((4, 4))),
                 lambda: image_io.imwrite("x.jpg", np.zeros((4, 4, 3), np.uint8))):
        with pytest.raises(ImportError, match="OpenCV"):
            call()


def test_in_memory_preparation_needs_no_codec(monkeypatch):
    """Frames of the bucket's size go through prepare_mvs_sample without cv2."""
    rng = np.random.RandomState(5)
    images, cams = _frames(rng, [(32, 64)] * 3), [_cam(rng, 32, 64) for _ in range(3)]
    ref = tpre.prepare_mvs_sample(images, cams, 3, max_d=8, max_h=32, max_w=64)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tpre.prepare_mvs_sample(images, cams, 3, max_d=8, max_h=32, max_w=64)
    np.testing.assert_array_equal(got["images"], ref["images"])
    with pytest.raises(ImportError, match="OpenCV"):
        tpre.prepare_mvs_sample(_frames(rng, [(64, 128)] * 3), cams, 3, max_d=8, max_h=32, max_w=64)


# ---- preprocess: the single steps ----------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_center_image(dtype):
    img = _frames(np.random.RandomState(6), [(37, 53)], dtype)[0]
    got, ref = tpre.center_image(img), jpre.center_image(img)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.mean(axis=(0, 1)), 0.0, atol=1e-5)


@pytest.mark.parametrize("scale,inter", [(1.0, "linear"), (1.0, "nearest"), (0.5, "linear"),
                                         (0.37, "linear"), (0.5, "nearest"), (1.6, "linear")])
def test_scale_image(scale, inter):
    img = _frames(np.random.RandomState(7), [(37, 53)])[0]
    got = tpre.scale_image(img, scale, inter)
    np.testing.assert_array_equal(got, jpre.scale_image(img, scale, inter))
    if scale == 1.0:
        # the port returns the image itself; cv2.resize at fx = fy = 1 is the identity
        assert got is img
        flag = cv2.INTER_LINEAR if inter == "linear" else cv2.INTER_NEAREST
        np.testing.assert_array_equal(cv2.resize(img, None, fx=1.0, fy=1.0, interpolation=flag), img)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_scale_mvs_input(scale):
    rng = np.random.RandomState(8)
    images, cams = _frames(rng, [(40, 56), (40, 56)]), [_cam(rng, 40, 56) for _ in range(2)]
    depth = rng.rand(40, 56).astype(np.float32)
    gi, gc, gd = tpre.scale_mvs_input(images, cams, scale, depth)
    ri, rc, rd = jpre.scale_mvs_input(images, cams, scale, depth)
    _equal_lists(gi, ri)
    _equal_lists(gc, rc)
    np.testing.assert_array_equal(gd, rd)
    assert len(tpre.scale_mvs_input(images, cams, scale)) == 2


@pytest.mark.parametrize("sizes,max_hw", [
    ([(67, 99)], (64, 96)),               # odd margins both ways: the ceil'd crop start
    ([(66, 98)], (64, 96)),               # even margins
    ([(70, 50)], (64, 96)),               # taller than max, narrower: 50 rounds DOWN to 32
    ([(45, 45)], (64, 96)),               # below max, not a multiple of 32
    ([(64, 96)], (64, 96)),               # exact
    ([(67, 99), (64, 96), (80, 130)], (64, 96)),   # mixed sizes in one sample
])
def test_crop_mvs_input(sizes, max_hw):
    rng = np.random.RandomState(9)
    images = _frames(rng, sizes)
    cams = [_cam(rng, h, w) for h, w in sizes]
    depth = rng.rand(*sizes[-1]).astype(np.float32)
    gi, gc, gd = tpre.crop_mvs_input(images, cams, *max_hw, depth_image=depth)
    ri, rc, rd = jpre.crop_mvs_input(images, cams, *max_hw, depth_image=depth)
    _equal_lists(gi, ri)
    _equal_lists(gc, rc)
    np.testing.assert_array_equal(gd, rd)
    for im in gi:
        assert im.shape[0] % 32 == 0 and im.shape[1] % 32 == 0
    h, w = sizes[0]
    if (h, w) == (67, 99):          # margin 3: start is ceil(1.5) = 2, not 1
        np.testing.assert_array_equal(gi[0], images[0][2:66, 2:98])
        assert gc[0][1, 0, 2] == cams[0][1, 0, 2] - 2


def test_crop_mvs_input_too_small():
    rng = np.random.RandomState(10)
    with pytest.raises(ValueError, match="smaller than base_image_size"):
        tpre.crop_mvs_input(_frames(rng, [(20, 40)]), [_cam(rng, 20, 40)], 64, 96)


def test_pad_and_mask():
    rng = np.random.RandomState(11)
    images = _frames(rng, [(20, 30), (32, 64), (40, 20)])
    _equal_lists(tpre.pad_mvs_input(images, 32, 64), jpre.pad_mvs_input(images, 32, 64))
    assert tpre.pad_mvs_input(images, 32, 64)[0].shape == (32, 64, 3)
    depth = rng.rand(12, 9).astype(np.float32) * 3
    for d in (depth, depth[..., None]):
        got = tpre.mask_depth_image(d, 0.5, 2.0)
        np.testing.assert_array_equal(got, jpre.mask_depth_image(d, 0.5, 2.0))
        assert got.shape == (12, 9, 1)


@pytest.mark.parametrize("depth_row", [(0.5, 0.01, 0.0, 0.0), (0.5, 0.01, 64.0, 1.4),
                                       (2.0, 0.5, 32.0, 0.0)])
def test_to_inverse_depth_range(depth_row):
    cam = _cam(np.random.RandomState(12), 32, 32, depth_row)
    got = tpre.to_inverse_depth_range(cam, 48)
    np.testing.assert_array_equal(got, jpre.to_inverse_depth_range(cam, 48))
    assert got[1, 3, 2] == 48 and got[1, 3, 3] == 1.0 / depth_row[0]


@pytest.mark.parametrize("inverse", [True, False])
def test_sweep_range_from_gt(inverse):
    rng = np.random.RandomState(13)
    gt = rng.rand(16, 20).astype(np.float32) * 3 + 0.5
    gt[2:4, 5:9] = 0.0                       # holes: the masking-order quirk shows here
    gt[7, 7] = -1.0
    cams = [_cam(rng, 16, 20) for _ in range(3)]
    got = tpre.sweep_range_from_gt(cams, gt, 16, inverse_depth=inverse)
    _equal_lists(got, jpre.sweep_range_from_gt(cams, gt, 16, inverse_depth=inverse))
    lo, hi = got[0][1, 3, 0], got[0][1, 3, 3]
    assert 0 < lo < hi and np.isfinite(hi)
    np.testing.assert_array_equal(got[0][0], cams[0][0])


def test_find_and_read_gt_depth(tmp_path):
    (tmp_path / "images").mkdir()
    (tmp_path / "depths").mkdir()
    ref = str(tmp_path / "images" / "00000003.jpg")
    assert tpre.find_gt_depth_path(ref) is None
    (tmp_path / "images" / "00000003.txt").write_text("scan_view7.png\n")
    assert tpre.find_gt_depth_path(ref) is None
    gt = np.random.RandomState(14).rand(6, 8).astype(np.float32)
    tpfm.save_pfm(str(tmp_path / "depths" / "scan_view7.pfm"), gt)
    path = tpre.find_gt_depth_path(ref)
    assert path == jpre.find_gt_depth_path(ref) and path.endswith("scan_view7.pfm")
    np.testing.assert_array_equal(tpre.read_gt_depth(path), jpre.read_gt_depth(path))
    # .exr goes to data/mvs_syn._read_exr_depth: a missing or undecodable file raises IOError
    # naming the path, never an AttributeError from a decoder's None
    with pytest.raises(IOError, match="scan_view7.exr"):
        tpre.read_gt_depth(str(tmp_path / "depths" / "scan_view7.exr"))
    (tmp_path / "depths" / "garbage.exr").write_bytes(b"not an exr at all")
    with pytest.raises(IOError, match="garbage.exr"):
        tpre.read_gt_depth(str(tmp_path / "depths" / "garbage.exr"))
    # an .exr beside the .pfm wins, as in the original
    assert tpre.find_gt_depth_path(ref) == jpre.find_gt_depth_path(ref)


# ---- preprocess: the whole policy ------------------------------------------------------


def _assert_same_sample(got, ref, center):
    assert set(got) == set(ref)
    assert got["valid_hw"] == ref["valid_hw"]
    assert got["cams"].dtype == ref["cams"].dtype == np.float32
    np.testing.assert_array_equal(got["cams"], ref["cams"])
    np.testing.assert_array_equal(got["images_raw"], ref["images_raw"])
    assert got["images"].dtype == ref["images"].dtype and got["images"].shape == ref["images"].shape
    if center:
        np.testing.assert_allclose(got["images"], ref["images"], rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got["images"], ref["images"])
    for key in set(got) - {"valid_hw", "cams", "images_raw", "images"}:
        assert got[key] == ref[key]


PREPARE_CASES = {
    "larger": ([(100, 150)] * 3, {}),                    # downscaled into the bucket
    "larger_odd": ([(131, 203)] * 3, {}),
    "equal": ([(64, 96)] * 3, {}),
    "smaller": ([(50, 70)] * 3, {}),                     # padded bottom/right, valid_hw tracked
    "smaller_one_axis": ([(64, 70)] * 3, {}),
    "mixed": ([(64, 96), (80, 120), (64, 100)], {}),
    "mixed_small": ([(50, 70), (64, 96), (40, 96)], {}),
    "two_of_three_views": ([(64, 96)] * 2, {}),          # padded with the reference view
    "five_of_three_views": ([(64, 96)] * 5, {}),         # truncated
    "metric_sweep": ([(64, 96)] * 3, {"inverse_depth": False}),
    "no_adaptive_scaling": ([(100, 150)] * 3, {"adaptive_scaling": False}),
    "with_gt_range": ([(64, 96)] * 3, {"gt": True}),
    "num_d_in_cam": ([(64, 96)] * 3, {"depth_row": (0.5, 0.01, 64.0, 1.4)}),
}


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("case", list(PREPARE_CASES))
def test_prepare_mvs_sample(case, center):
    sizes, opts = PREPARE_CASES[case]
    opts = dict(opts)
    rng = np.random.RandomState(15)
    images = _frames(rng, sizes)
    cams = [_cam(rng, h, w, opts.pop("depth_row", (0.5, 0.01, 0.0, 0.0))) for h, w in sizes]
    if opts.pop("gt", False):
        opts["gt_depth"] = rng.rand(16, 24).astype(np.float32) + 0.6
    kw = dict(max_d=16, max_h=64, max_w=96, center=center, **opts)
    before = [c.copy() for c in cams]
    got = tpre.prepare_mvs_sample(images, cams, 3, **kw)
    ref = jpre.prepare_mvs_sample(images, cams, 3, **kw)
    _assert_same_sample(got, ref, center)
    _equal_lists(cams, before)                       # the caller's cams are not written to
    assert got["images"].shape == (1, 3, 64, 96, 3)
    assert got["images"].dtype == (np.float32 if center else np.uint8)
    if case == "smaller":
        assert got["valid_hw"] == (50, 70)
        np.testing.assert_array_equal(got["images_raw"][0, 0, :50, :70], images[0])
        np.testing.assert_array_equal(got["images_raw"][0, 0, 50:, :70],
                                      np.broadcast_to(images[0][49:50], (14, 70, 3)))


def test_load_mvs_sample_from_files(tmp_path):
    rng = np.random.RandomState(16)
    for sub in ("images", "cams", "depths"):
        (tmp_path / sub).mkdir()
    paths = []
    for v in range(3):
        img = str(tmp_path / "images" / f"{v:08d}.png")
        cam = str(tmp_path / "cams" / f"{v:08d}_cam.txt")
        cv2.imwrite(img, _frames(rng, [(80, 120)])[0])
        tcams.write_cam(cam, _cam(rng, 80, 120, (0.5, 0.02, 0.0, 0.0)))
        paths += [img, cam]
    (tmp_path / "images" / "00000000.txt").write_text("gt0.png\n")
    tpfm.save_pfm(str(tmp_path / "depths" / "gt0.pfm"), rng.rand(20, 30).astype(np.float32) + 0.7)
    for gt_range in (False, True):
        kw = dict(max_d=16, max_h=64, max_w=96, gt_range=gt_range)
        got, ref = tpre.load_mvs_sample(paths, 3, **kw), jpre.load_mvs_sample(paths, 3, **kw)
        _assert_same_sample(got, ref, center=True)
        assert got["index"] == 0
    assert not np.array_equal(got["cams"][0, 0, 1, 3], tpre.load_mvs_sample(
        paths, 3, max_d=16, max_h=64, max_w=96)["cams"][0, 0, 1, 3])


@pytest.mark.parametrize("with_gt", [True, False])
def test_load_example_dir(tmp_path, with_gt):
    rng = np.random.RandomState(17)
    for v in range(3):
        cv2.imwrite(str(tmp_path / f"{v}.jpg"), _frames(rng, [(32, 64)])[0])
        np.save(str(tmp_path / f"{v}_cam.npy"), _cam(rng, 32, 64))
    if with_gt:
        np.save(str(tmp_path / "0_gt.npy"), rng.rand(32, 64).astype(np.float32))
    got, ref = tpre.load_example_dir(str(tmp_path), 3), jpre.load_example_dir(str(tmp_path), 3)
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    # raw, un-normalized BGR frames: values stay in 0..255
    assert got[0].shape == (1, 3, 32, 64, 3) and got[0].max() > 100
    if with_gt:
        np.testing.assert_array_equal(got[2], ref[2])
    else:
        assert got[2] is None and ref[2] is None


# ---- error metrics and their reports ---------------------------------------------------


def _depth_pair(seed, nan=False):
    rng = np.random.RandomState(seed)
    gt = rng.rand(24, 32).astype(np.float32) * 3 + 0.5
    pred = gt + rng.randn(24, 32).astype(np.float32) * 0.05
    gt[:3, :5] = 0.0
    pred[5, 5] = 0.0
    if nan:
        gt[10, 10] = np.nan
        pred[11, 11] = np.nan
    return pred, gt


@pytest.mark.parametrize("seed,nan", [(0, False), (1, True), (2, False)])
def test_calc_error_and_error_dict(seed, nan):
    pred, gt = _depth_pair(seed, nan)
    got, ginfo = terr.calc_error(pred, gt)
    ref, rinfo = jerr.calc_error(pred, gt)
    np.testing.assert_array_equal(got, ref)
    assert ginfo == rinfo
    assert terr.error_dict(got) == jerr.error_dict(ref)
    assert list(terr.error_dict(got)) == terr.ERR_METRICS + terr.ACC_METRICS
    assert terr.ERR_METRICS == jerr.ERR_METRICS and terr.ACC_METRICS == jerr.ACC_METRICS
    got5, _ = terr.calc_error(pred, gt, num_depths=50, inlier_threshold=[2, 4])
    np.testing.assert_array_equal(got5, jerr.calc_error(pred, gt, num_depths=50, inlier_threshold=[2, 4])[0])


def _xlsx_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_save_error_report(tmp_path):
    errors, _ = terr.calc_error(*_depth_pair(3))
    terr.save_error_report(str(tmp_path / "t_error.xlsx"), errors, "sheet&1")
    jerr.save_error_report(str(tmp_path / "j_error.xlsx"), errors, "sheet&1")
    assert _read(tmp_path / "t_error.json") == _read(tmp_path / "j_error.json")
    assert json.loads(_read(tmp_path / "t_error.json")) == terr.error_dict(errors)
    assert _xlsx_members(tmp_path / "t_error.xlsx") == _xlsx_members(tmp_path / "j_error.xlsx")


def test_xlsx_writer_and_log_lists(tmp_path):
    for mod, name in ((txlsx, "t.xlsx"), (jxlsx, "j.xlsx")):
        wb = mod.Workbook(str(tmp_path / name))
        ws = wb.add_worksheet("a<b")
        ws.write(0, 0, "x&y")
        ws.write(1, 27, 1.5)
        ws.write(2, 1, 3)
        wb.close()
    members = _xlsx_members(tmp_path / "t.xlsx")
    assert members == _xlsx_members(tmp_path / "j.xlsx")
    assert b'r="AB2"' in members["xl/worksheets/sheet1.xml"]
    tlog.write_list(str(tmp_path / "t.txt"), ["a", 2, " b "])
    jlog.write_list(str(tmp_path / "j.txt"), ["a", 2, " b "])
    assert _read(tmp_path / "t.txt") == _read(tmp_path / "j.txt")
    assert tlog.read_list(str(tmp_path / "t.txt")) == jlog.read_list(str(tmp_path / "j.txt")) == ["a", "2", "b"]


@pytest.mark.parametrize("fmt", ["npy", "pfm"])
def test_eval_errors_cli(tmp_path, monkeypatch, capsys, fmt):
    pred, gt = _depth_pair(4)
    pp, gp = str(tmp_path / f"pred.{fmt}"), str(tmp_path / f"gt.{fmt}")
    for path, arr in ((pp, pred), (gp, gt)):
        np.save(path, arr) if fmt == "npy" else tpfm.save_pfm(path, arr)
    outs = []
    for mod, out in ((tcli_errors, "t.xlsx"), (jcli_errors, "j.xlsx")):
        monkeypatch.setattr(sys, "argv", ["eval_errors", pp, gp, "--out", str(tmp_path / out)])
        mod.main()
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1] and set(outs[0]) == set(terr.ERR_METRICS + terr.ACC_METRICS)
    assert _read(tmp_path / "t.json") == _read(tmp_path / "j.json")
