"""The port's two seams, on the CPU and without JAX.

The layers: the models layer writes the N-view stages once (models.atvsnet.forward_stages)
and imports nothing of parallel.pipeline, which builds on it; importing the models in a
fresh interpreter leaves that module out.

The kernel libraries: every hand-written kernel's module declares its library through
ops.nvcc.CudaLibrary (built on first use, loaded once, its entry points typed) and counts
its launches through ops.nvcc.launch_counts, whose reset_launch_counts zeroes every
launcher's counts with the path keys each kernel has always had; so do the pass leaves of
fp32_precision "high" and "default" (ops.fp32_passes), keyed by mode, and the bf16 conv
leaves (nn.layers.bf16_conv), keyed by kind.
"""

import ctypes
import ctypes.util
import os
import subprocess
import sys
import threading

import pytest

from atvsnet_torch.nn import layers
from atvsnet_torch.ops import (conv2d_fp32, conv3d_fp32, conv3d_transpose_fp32, fp32_passes,
                                int8_conv, nvcc, plane_sweep, softargmin)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# module -> its counted launchers and their path keys
LAUNCHERS = {
    softargmin: (("softargmin_cuda", "softargmin_backward_cuda", "softargmin_partial_cuda",
                  "softargmin_backward_stats_cuda"), ("aligned", "scalar")),
    int8_conv: (("conv3d_int8_cuda",), ("generic", "ring", "ring_cluster")),
    conv2d_fp32: (("conv2d_fp32_cuda",), ("vector", "scalar")),
    conv3d_fp32: (("conv3d_fp32_cuda",), ("vector", "scalar")),
    conv3d_transpose_fp32: (("conv3d_transpose_fp32_cuda",), ("vector", "scalar")),
    plane_sweep: (("plane_sweep_cuda",), tuple(f"{kind}.{path}" for kind in
                                               ("bilinear", "bilinear_nearest", "nearest")
                                               for path in ("vector", "scalar"))),
    fp32_passes: (("pass_conv", "pass_conv_transpose", "pass_matmul"), ("high", "default")),
    layers: (("bf16_conv",), ("conv2d", "conv3d", "conv_transpose")),
}


@pytest.mark.parametrize("module", ["atvsnet_torch.models.atvsnet", "atvsnet_torch.models.train"])
def test_the_models_import_nothing_of_the_pipeline(module):
    code = f"import sys, {module}; print('atvsnet_torch.parallel.pipeline' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


@pytest.mark.parametrize("module", list(LAUNCHERS), ids=[m.__name__ for m in LAUNCHERS])
def test_reset_launch_counts_zeroes_every_launcher(module):
    names, paths = LAUNCHERS[module]
    launchers = [getattr(module, n) for n in names]
    module.reset_launch_counts()
    try:
        for fn in launchers:
            for path in paths:
                nvcc.count_launch(fn, path, (1, 2))
            nvcc.count_launch(fn, paths[0], (3,))
            assert fn.launches == len(paths) + 1
            assert fn.path_launches == dict.fromkeys(paths, 1) | {paths[0]: 2}
            assert fn.shape_launches == {(1, 2): len(paths), (3,): 1}
    finally:
        module.reset_launch_counts()
    for fn in launchers:
        assert fn.launches == 0 and fn.shape_launches == {}
        assert fn.path_launches == dict.fromkeys(paths, 0)
        assert list(fn.path_launches) == list(paths)


def test_a_library_builds_and_loads_once_with_its_signatures(monkeypatch, tmp_path):
    """CudaLibrary: one build and one load however many first callers race; the entry
    points typed as declared; build_log kept; a kernel module's build_log reads its
    library's. nvcc is stood in by the C library here."""
    libc = ctypes.util.find_library("c")
    builds = []

    def fake_build(source, library, force=False):
        builds.append((source, library, force))
        return libc, "ptxas info: stood in"

    monkeypatch.setattr(nvcc, "nvcc_build", fake_build)
    lib = nvcc.CudaLibrary(tmp_path / "k.cu", tmp_path / "k.so",
                           {"abs": ([ctypes.c_int], ctypes.c_int)})
    got = []
    threads = [threading.Thread(target=lambda: got.append(lib())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got) and len(builds) == 1
    assert got[0].abs.argtypes == [ctypes.c_int] and got[0].abs(-7) == 7
    assert lib.build_log == "ptxas info: stood in"
    assert lib.build(force=True) == libc and builds[-1][2] is True
    assert softargmin.build_log == softargmin.LIB.build_log
    with pytest.raises(AttributeError):
        softargmin.no_such_name
