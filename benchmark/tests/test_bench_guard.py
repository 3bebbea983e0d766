"""What the benchmark may import, by whole top-level module names: nothing under
benchmark/ imports JAX or the JAX package, and the plain reference imports nothing of the
program either."""

import os

import pytest

from benchmark import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_MAY = {"__future__", "hashlib", "math", "os", "re", "numpy", "torch", "cv2",
                 "benchmark"}


def _sources(under):
    for d, _, files in os.walk(os.path.join(BENCH, under)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_are_compared_whole():
    assert guard.top_level("atvsnet_torch.ops.softargmin") == "atvsnet_torch"
    assert guard.loaded(modules=["atvsnet_torch", "atvsnet_torch.serving", "jaxtyping",
                                 "flaxen"]) == []
    assert guard.loaded(modules=["atvsnet_tpu.nn", "jax._src.core", "numpy"]) == [
        "atvsnet_tpu", "jax"]
    assert guard.imports_of("import jax.numpy as jnp\nfrom atvsnet_tpu import x\n"
                            "from . import y\nimport atvsnet_torch.serving") == {
        "jax", "atvsnet_tpu", "atvsnet_torch"}


@pytest.mark.parametrize("path", sorted(_sources("")), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        assert not guard.imports_of(f.read()) & guard.BANNED


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    with open(path) as f:
        names = guard.imports_of(f.read())
    assert "atvsnet_torch" not in names
    assert names <= REFERENCE_MAY, names - REFERENCE_MAY
    with open(path) as f:
        text = f.read()
    # from benchmark, only the reference's own modules
    assert "from benchmark import" not in text
    assert all(line.split()[1].startswith("benchmark.reference")
               for line in text.splitlines() if line.startswith("from benchmark"))


def test_a_harness_run_loads_neither():
    """A fresh process that imports the harness, both drivers, the reference and the
    program's entry points holds no banned module."""
    import subprocess
    import sys

    code = ("import benchmark.harness, benchmark.drivers.eval_scenes, "
            "benchmark.drivers.serve_closed_loop, benchmark.reference.model, "
            "atvsnet_torch.serving, atvsnet_torch.cli.eval_pointcloud, "
            "atvsnet_torch.fusion.fuse\n"
            "from benchmark import guard; print(guard.loaded())")
    root = os.path.dirname(BENCH)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=root))
    assert out.stdout.strip().splitlines()[-1] == "[]"
