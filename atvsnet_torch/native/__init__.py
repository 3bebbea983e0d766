"""ctypes bindings for the host library native/atvsnet_native.cpp (C++/OpenMP): masked
point-cloud compaction, compaction with float64 back-projection, and the binary PLY
writer (the port of atvsnet_tpu/native/__init__.py).

The library is built from the source in this repository on first use, with
`g++ -O3 -shared -fPIC -fopenmp` (no -march: the build must run on whatever machine
loads it), into build/atvsnet_torch/libatvsnet_torch_native.so. A prebuilt library next
to the source is never loaded and nothing is written there.

Every function has a numpy version beside it (`*_numpy`), which is what the native one is
held against. Where no compiler is found the numpy versions are used, with one warning;
`get_lib()` returns None then, and `require_lib()` raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from atvsnet_torch.utils import log

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "atvsnet_native.cpp"
BUILD_DIR = _REPO / "build" / "atvsnet_torch"
LIBRARY = BUILD_DIR / "libatvsnet_torch_native.so"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp"]

_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False) -> Path:
    """Compile SOURCE into LIBRARY unless an up-to-date build exists; raises on failure."""
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader sees the old or the new file
    return LIBRARY


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.atv_count_mask.restype = i64
    lib.atv_count_mask.argtypes = [vp, i64]
    lib.atv_compact_points.restype = i64
    lib.atv_compact_points.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.atv_compact_backproject.restype = i64
    lib.atv_compact_backproject.argtypes = [vp, vp, vp, vp, i64, i64, vp, vp]
    lib.atv_write_ply.restype = ctypes.c_int
    lib.atv_write_ply.argtypes = [ctypes.c_char_p, vp, vp, i64]
    return lib


def get_lib():
    """The loaded library, built on first use; None (after one warning) when it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                log.warn(f"native host library unavailable ({e}); using the numpy versions")
        return _lib


def require_lib() -> ctypes.CDLL:
    """get_lib(), or RuntimeError where the library could not be built or loaded."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native host library could not be built from {SOURCE}")
    return lib


def count_mask_numpy(mask: np.ndarray) -> int:
    return int(np.count_nonzero(mask))


def count_mask(mask: np.ndarray) -> int:
    """Number of set bytes in a bool/uint8 mask."""
    mask = np.ascontiguousarray(mask.reshape(-1).astype(np.uint8, copy=False))
    lib = get_lib()
    if lib is None:
        return count_mask_numpy(mask)
    return int(lib.atv_count_mask(mask.ctypes.data, mask.shape[0]))


def _flat_compact_inputs(mask, points, colors):
    return (np.ascontiguousarray(mask.reshape(-1).astype(np.uint8)),
            np.ascontiguousarray(points.reshape(-1, 3).astype(np.float32)),
            np.ascontiguousarray(colors.reshape(-1, 3).astype(np.float32)))


def compact_points_numpy(mask: np.ndarray, points: np.ndarray, colors: np.ndarray):
    mask, points, colors = _flat_compact_inputs(mask, points, colors)
    m = mask.astype(bool)
    pts = points[m]
    pts[~np.isfinite(pts)] = 0.0
    return pts, np.clip(colors[m], 0, 255).astype(np.uint8)


def compact_points(mask: np.ndarray, points: np.ndarray, colors: np.ndarray):
    """mask (n,) bool/uint8, points (n,3) f32, colors (n,3) float 0..255
    -> (m,3) f32 points, (m,3) u8 colors, in the mask's order.

    Deliberate deviation from the reference host loop (fusibile.cu:308): that loop
    silently drops any point with a zero X, Y or Z world coordinate (an artifact of
    zero-initialized buffers doubling as a validity flag); here validity is the
    explicit mask, so points that legitimately lie on a coordinate plane are kept.
    Non-finite coordinates become 0; colors are clamped to 0..255 and truncated."""
    lib = get_lib()
    if lib is None:
        return compact_points_numpy(mask, points, colors)
    mask, points, colors = _flat_compact_inputs(mask, points, colors)
    n = mask.shape[0]
    count = lib.atv_count_mask(mask.ctypes.data, n)
    out_pts = np.empty((count, 3), np.float32)
    out_rgb = np.empty((count, 3), np.uint8)
    written = lib.atv_compact_points(
        mask.ctypes.data, points.ctypes.data, colors.ctypes.data, n,
        out_pts.ctypes.data, out_rgb.ctypes.data,
    )
    assert written == count, (written, count)
    return out_pts, out_rgb


def _backproject_inputs(packed, depth, Minv, P4):
    H, W = depth.shape
    return (np.ascontiguousarray(packed.reshape(H * W, 4).astype(np.uint8, copy=False)),
            np.ascontiguousarray(depth.astype(np.float32, copy=False)),
            np.ascontiguousarray(Minv.astype(np.float64, copy=False)),
            np.ascontiguousarray(P4.astype(np.float64, copy=False)))


def backproject_rows(depth: np.ndarray, pix: np.ndarray, Minv: np.ndarray,
                     P4: np.ndarray) -> np.ndarray:
    """Float64 back-projection X = Minv @ (d*[x, y, 1] - P4) of the flat pixel indices
    `pix` of depth (H, W), rounded to float32, non-finite zeroed (fusibile.cu:56-65)."""
    W = depth.shape[1]
    d = depth.reshape(-1)[pix].astype(np.float64)
    Minv = np.asarray(Minv, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):  # a non-finite depth gives the point 0
        px, py, pz = d * (pix % W) - P4[0], d * (pix // W) - P4[1], d - P4[2]
        # written out as the library writes it (no matrix product: BLAS would fuse the
        # multiply-adds and round the last bit of a few points the other way)
        pts = np.stack([Minv[k, 0] * px + Minv[k, 1] * py + Minv[k, 2] * pz for k in range(3)],
                       -1).astype(np.float32)
    pts[~np.isfinite(pts)] = 0.0
    return pts


def compact_backproject_numpy(packed: np.ndarray, depth: np.ndarray,
                              Minv: np.ndarray, P4: np.ndarray):
    packed, depth, Minv, P4 = _backproject_inputs(packed, depth, Minv, P4)
    idx = np.flatnonzero(packed[:, 0])
    return backproject_rows(depth, idx, Minv, P4), packed[idx, 1:4].copy()


def compact_backproject(packed: np.ndarray, depth: np.ndarray,
                        Minv: np.ndarray, P4: np.ndarray):
    """packed (H, W, 4) uint8 [emit, r, g, b] (a fusion chunk's one downloaded array),
    depth (H, W) f32 host-resident reference depth, Minv (3,3) / P4 (3,) float64 camera
    geometry -> (m,3) f32 points, (m,3) u8 colors.

    World coordinates are recomputed here, in float64, from the depth map the host
    already holds, instead of being downloaded: 4 bytes per pixel come down, not 16."""
    lib = get_lib()
    if lib is None:
        return compact_backproject_numpy(packed, depth, Minv, P4)
    H, W = depth.shape
    packed, depth, Minv, P4 = _backproject_inputs(packed, depth, Minv, P4)
    count = int(np.count_nonzero(packed[:, 0]))
    out_pts = np.empty((count, 3), np.float32)
    out_rgb = np.empty((count, 3), np.uint8)
    written = lib.atv_compact_backproject(
        packed.ctypes.data, depth.ctypes.data, Minv.ctypes.data, P4.ctypes.data,
        H, W, out_pts.ctypes.data, out_rgb.ctypes.data,
    )
    assert written == count, (written, count)
    return out_pts, out_rgb


def write_ply_numpy(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary little-endian PLY, xyz float32 + rgb uchar (fusibile/displayUtils.h:80-136)."""
    n = points.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = points
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Write points (n,3) and colors (n,3) as a PLY: the library's writer, or numpy's."""
    points = np.ascontiguousarray(np.asarray(points, "<f4"))
    colors = np.ascontiguousarray(np.asarray(colors, np.uint8))
    lib = get_lib()
    if lib is None:
        return write_ply_numpy(path, points, colors)
    rc = lib.atv_write_ply(os.fsencode(path), points.ctypes.data, colors.ctypes.data,
                           points.shape[0])
    if rc != 0:
        raise IOError(f"atv_write_ply failed with {rc} for {path}")
