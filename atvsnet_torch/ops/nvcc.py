"""Building and loading the port's CUDA sources: nvcc compiles one .cu file with a plain C
interface into a shared library under build/atvsnet_torch/, which `CudaLibrary` loads with
ctypes. A build happens at first use (or when the source is newer than the library); the
libraries are never committed. `launch_counts` and `count_launch` keep each launcher's
counts of its launches, which tests, chip_smoke.py and the benchmark read; `counts_since`
and `add_counts` let a CUDA graph's replay count what its capture counted."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "atvsnet_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def nvcc_build(source: Path, library: Path, force: bool = False) -> tuple[Path, Optional[str]]:
    """Compile `source` into `library` unless an up-to-date build exists. Returns the
    library and nvcc's output (None when nothing was built); raises if nvcc fails."""
    if not force and library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return library, None
    library.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=library.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, library)  # atomic: a concurrent loader sees the old or the new file
    return library, log


class CudaLibrary:
    """One .cu source with a plain C interface, built by nvcc into `library` and loaded
    with ctypes on first use (under a lock, so concurrent first callers load it once).

    signatures: {entry point: (argtypes, restype)}; every pointer and the stream are
    c_void_p, which ctypes would otherwise cut to 32 bits. Calling the object returns the
    loaded library; `build(force)` compiles without loading, and `build_log` keeps nvcc's
    output of the last build that ran."""

    def __init__(self, source: Path, library: Path, signatures: dict):
        self.source, self.library, self.signatures = source, library, signatures
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self, force: bool = False) -> Path:
        """Compile the source into the library unless an up-to-date build exists."""
        library, log = nvcc_build(self.source, self.library, force)
        if log is not None:
            self.build_log = log
        return library

    def __call__(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (argtypes, restype) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                self._lib = lib
        return self._lib

    def module_getattr(self, module: str) -> Callable:
        """A kernel module's __getattr__: its `build_log` reads this library's."""
        def __getattr__(name: str):
            if name == "build_log":
                return self.build_log
            raise AttributeError(f"module {module!r} has no attribute {name!r}")

        return __getattr__


def count_launch(launcher, path: str, shape) -> None:
    """Count one launch of `launcher` on `path` for the key `shape`."""
    launcher.launches += 1
    launcher.path_launches[path] += 1
    launcher.shape_launches[shape] = launcher.shape_launches.get(shape, 0) + 1


LAUNCHERS: list = []
"""(launcher, recorded_only) of every launcher given counts by launch_counts."""


def launch_counts(paths: Sequence[str], *launchers,
                  recorded_only: bool = False) -> Callable[[], None]:
    """Give each launcher its counts, `launches` (in total), `path_launches` (per path of
    `paths`) and `shape_launches` (per key), all 0, and return the module's
    reset_launch_counts, which sets them to 0 again. recorded_only: the launchers count
    only while a profiler records (utils.profiling.recording)."""
    LAUNCHERS.extend((fn, recorded_only) for fn in launchers)

    def reset_launch_counts() -> None:
        """Set the kernel's launch counts (total, per path and per shape) to 0."""
        for fn in launchers:
            fn.launches = 0
            fn.path_launches = dict.fromkeys(paths, 0)
            fn.shape_launches = {}

    reset_launch_counts()
    return reset_launch_counts


def snapshot_counts() -> list:
    """Every launcher's counts as they are now, for counts_since."""
    return [(fn, fn.launches, dict(fn.path_launches), dict(fn.shape_launches))
            for fn, _ in LAUNCHERS]


def counts_since(snapshot: list) -> list:
    """The launches counted since `snapshot`, as (launcher, recorded_only, launches, per
    path, per key) of each launcher that counted any; the counts are set back to the
    snapshot's. A graph capture counts its launches once and each replay adds them."""
    recorded = dict(LAUNCHERS)
    deltas = []
    for fn, launches, paths, shapes in snapshot:
        n = fn.launches - launches
        if n:
            deltas.append((fn, recorded[fn], n,
                           {k: v - paths.get(k, 0) for k, v in fn.path_launches.items()
                            if v != paths.get(k, 0)},
                           {k: v - shapes.get(k, 0) for k, v in fn.shape_launches.items()
                            if v != shapes.get(k, 0)}))
        fn.launches, fn.path_launches, fn.shape_launches = launches, paths, shapes
    return deltas


def add_counts(deltas: list, recording: bool) -> None:
    """Add counts_since's deltas to the launchers' counts: all of them while a profiler
    records, those of launchers that count whether or not one does otherwise."""
    for fn, recorded_only, launches, paths, shapes in deltas:
        if recorded_only and not recording:
            continue
        fn.launches += launches
        for k, v in paths.items():
            fn.path_launches[k] = fn.path_launches.get(k, 0) + v
        for k, v in shapes.items():
            fn.shape_launches[k] = fn.shape_launches.get(k, 0) + v
