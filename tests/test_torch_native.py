"""The port's host library (atvsnet_torch.native): each function against its numpy version
and against atvsnet_tpu.native's, to equality. The library is built from
native/atvsnet_native.cpp into build/atvsnet_torch/; the prebuilt library beside the source
is neither loaded nor touched.
"""

import os

import numpy as np
import pytest

import atvsnet_tpu.native as jnative
from atvsnet_torch import native
from atvsnet_torch.fusion.ply import read_ply

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PREBUILT = os.path.join(ROOT, "native", "libatvsnet_native.so")


@pytest.fixture(scope="module")
def lib():
    before = os.stat(PREBUILT).st_mtime_ns if os.path.exists(PREBUILT) else None
    lib = native.require_lib()
    after = os.stat(PREBUILT).st_mtime_ns if os.path.exists(PREBUILT) else None
    assert before == after
    return lib


def test_built_into_the_build_directory(lib):
    assert str(native.LIBRARY) == os.path.join(ROOT, "build", "atvsnet_torch",
                                               "libatvsnet_torch_native.so")
    assert native.LIBRARY.exists() and native.get_lib() is lib
    assert str(native.SOURCE) == os.path.join(ROOT, "native", "atvsnet_native.cpp")
    assert "-march=native" not in native.CXX_FLAGS and "-fopenmp" in native.CXX_FLAGS
    assert lib._name == str(native.LIBRARY)
    assert native.build() == native.LIBRARY                    # up to date: no rebuild
    mtime = native.LIBRARY.stat().st_mtime_ns
    native.build()
    assert native.LIBRARY.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("n", [0, 1, 10007, 200_000])
def test_count_mask(lib, n):
    mask = np.random.RandomState(n).rand(n) > 0.4
    assert native.count_mask(mask) == native.count_mask_numpy(mask) == int(mask.sum())
    assert native.count_mask(mask.astype(np.uint8) * 7) == int(mask.sum())


@pytest.mark.parametrize("n,keep", [(10007, 0.5), (200_000, 0.1), (100, 0.0), (70_000, 1.0)])
def test_compact_points(lib, n, keep):
    rng = np.random.RandomState(n)
    mask = rng.rand(n) < keep
    pts = rng.randn(n, 3).astype(np.float32)
    pts[n // 3] = np.inf                       # non-finite coordinates are zeroed
    pts[n // 2, 1] = np.nan
    cols = (rng.rand(n, 3) * 300 - 20).astype(np.float32)      # clamped, then truncated
    got = native.compact_points(mask, pts, cols)
    for want in (native.compact_points_numpy(mask, pts, cols),
                 jnative.compact_points(mask, pts, cols)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == (int(mask.sum()), 3) and got[0].dtype == np.float32
    assert got[1].dtype == np.uint8 and np.isfinite(got[0]).all()
    # any leading shape: a (R, H, W) chunk goes in as it is
    if n == 70_000:
        again = native.compact_points(mask.reshape(7, 100, 100), pts.reshape(7, 100, 100, 3),
                                      cols.reshape(7, 100, 100, 3))
        np.testing.assert_array_equal(again[0], got[0])


def _backproject_scene(seed, H, W):
    rng = np.random.RandomState(seed)
    packed = np.zeros((H, W, 4), np.uint8)
    packed[..., 0] = rng.rand(H, W) > 0.5
    packed[..., 1:] = rng.randint(0, 256, (H, W, 3))
    depth = (1.0 + rng.rand(H, W)).astype(np.float32)
    depth[0, 0] = np.inf
    packed[0, 0, 0] = 1                         # a non-finite point that emits: zeroed
    K = np.array([[40.0, 0.3, W / 2], [0, 41.0, H / 2], [0, 0, 1.0]])
    P = K @ np.hstack([np.eye(3), np.array([[0.1], [-0.2], [0.3]])])
    return packed, depth, np.linalg.inv(P[:, :3]), P[:, 3]


@pytest.mark.parametrize("hw", [(37, 53), (300, 400), (1, 1)])
def test_compact_backproject(lib, hw):
    packed, depth, Minv, P4 = _backproject_scene(sum(hw), *hw)
    got = native.compact_backproject(packed, depth, Minv, P4)
    ref = native.compact_backproject_numpy(packed, depth, Minv, P4)
    theirs = jnative.compact_backproject(packed, depth, Minv, P4)
    assert got[0].shape == (int(np.count_nonzero(packed[..., 0])), 3)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[1], theirs[1])
    # float64 arithmetic rounded to float32: the compiler may contract a*b+c, so 1 ulp
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-7, atol=1e-7)
    np.testing.assert_allclose(got[0], theirs[0], rtol=2e-7, atol=1e-7)
    assert (got[0][0] == 0).all() and np.isfinite(got[0]).all()
    # the sparse path's rows: the same points from a list of flat pixel indices
    idx = np.flatnonzero(packed[..., 0].reshape(-1))
    np.testing.assert_array_equal(native.backproject_rows(depth, idx, Minv, P4), ref[0])


@pytest.mark.parametrize("n", [0, 5, 300_001])
def test_write_ply(lib, tmp_path, n):
    rng = np.random.RandomState(n)
    pts = rng.randn(n, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    ours, plain, theirs = (str(tmp_path / f"{k}.ply") for k in ("ours", "plain", "theirs"))
    native.write_ply(ours, pts, rgb)
    native.write_ply_numpy(plain, pts, rgb)
    assert jnative.write_ply_native(theirs, pts, rgb)
    with open(ours, "rb") as a, open(plain, "rb") as b, open(theirs, "rb") as c:
        data = a.read()
        assert data == b.read() == c.read()
    p2, c2 = read_ply(ours)
    np.testing.assert_array_equal(p2, pts)
    np.testing.assert_array_equal(c2, rgb)
    with pytest.raises(IOError, match="atv_write_ply"):
        native.write_ply(str(tmp_path / "no_such_dir" / "x.ply"), pts, rgb)


def test_numpy_versions_serve_without_a_compiler(monkeypatch, tmp_path):
    """Where the library cannot be built the numpy versions answer, after one warning, and
    require_lib raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "none.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    warned = []
    monkeypatch.setattr(native.log, "warn", lambda *a: warned.append(a))
    assert native.get_lib() is None and native.get_lib() is None
    assert len(warned) == 1 and "g++ not found" in str(warned[0])
    with pytest.raises(RuntimeError, match="could not be built"):
        native.require_lib()
    packed, depth, Minv, P4 = _backproject_scene(1, 9, 11)
    got = native.compact_backproject(packed, depth, Minv, P4)
    ref = native.compact_backproject_numpy(packed, depth, Minv, P4)
    np.testing.assert_array_equal(got[0], ref[0])
    mask = packed[..., 0].astype(bool)
    pts, cols = native.compact_points(mask, np.ones((9, 11, 3), np.float32),
                                      packed[..., 1:].astype(np.float32))
    assert pts.shape == (int(mask.sum()), 3) and native.count_mask(mask) == int(mask.sum())
    native.write_ply(str(tmp_path / "x.ply"), pts, cols)
    np.testing.assert_array_equal(read_ply(str(tmp_path / "x.ply"))[1], cols)
