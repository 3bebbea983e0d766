"""Building the port's CUDA sources: nvcc compiles one .cu file with a plain C interface
into a shared library under build/atvsnet_torch/, which the wrappers load with ctypes.
A build happens at first use (or when the source is newer than the library); the
libraries are never committed."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

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
