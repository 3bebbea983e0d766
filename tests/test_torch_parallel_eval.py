"""The port's eval script on a mesh (run_eval_pc(mesh="data=2")) on a gloo world of 2
processes on the CPU, against the same script run unsharded; and, on the same world, the
sharded forward on a (2, 1) mesh against the JAX package's jit_sharded_forward on a (2, 1)
virtual mesh.

Eval: two fabricated ETH3D-format scenes of 3 images (64x96, D=8, 3 views, the trained
spheres weights, so that the fusion keeps points); batch 1 becomes 2 on the mesh, so each scene's last batch holds a
padding row. Every file of the unsharded run is written, once, by the ranks' own rows:
.jpg and .txt byte for byte, depth and confidence PFMs within rtol 1e-5, atol 1e-4 (the
eval tests' bound; the ranks run the same rows at the same batch size). Then rank 0 fuses
each scene once every rank has returned, and the cloud is the unsharded run's to the
fusion tolerance of tests/test_torch_fusion.py.

Forward: 5 views, 32x32, D=8, a batch of two scenes, at tests/test_torch_parallel_forward.py's
bounds (JAX: depths rtol 1e-3, atol 1e-4, tests/test_parallel.py:80; volumes rtol 1e-4,
atol 5e-4; the port in one process: depths rtol 1e-5, atol 2e-5).
"""

import filecmp
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from atvsnet_tpu.parallel.pipeline import jit_sharded_forward
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.pfm import load_pfm
from atvsnet_torch.data.synthetic import synthetic_scene, write_eth3d_scene
from atvsnet_torch.fusion.fuse import fuse_scene
from atvsnet_torch.fusion.ply import read_ply
from atvsnet_torch.params import export_jax_params, init_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd

from tests._torch_world import eval_cases, forward_cases, run_world, several
from tests.test_torch_fusion import assert_same_cloud

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SCENES = ["one", "two"]
EVAL_KW = dict(view_num=3, max_d=8, max_h=64, max_w=96)
SIZE = dict(view_num=5, max_d=8, max_h=32, max_w=32)
KEYS = ("depth_agg_initial", "depth_views", "depth", "depth_up", "refined_prob_volumes")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    data_root = str(root / "data")
    for i, scene in enumerate(SCENES):
        write_eth3d_scene(os.path.join(data_root, "eth3d", scene), 3, 64, 96, seed=i, num_d=8,
                          num_spheres=2)
    params_path = SPHERES

    model = init_model(PipelineConfig(**SIZE), seed=0, device="cpu")
    tree = export_jax_params(model)
    scenes = [synthetic_scene(view_num=5, H=32, W=32, D=8, seed=s) for s in (3, 5)]
    images, cams = (np.concatenate([s[i] for s in scenes]) for i in (0, 1))
    jax_out = {}

    def jax_forward():
        out = jit_sharded_forward(jax_make_mesh(2, 1), JaxConfig(**SIZE))(
            _unflatten(tree), jnp.asarray(images), jnp.asarray(cams))
        jax_out.update({k: np.asarray(v) for k, v in out.items()})

    thread = threading.Thread(target=jax_forward)
    thread.start()
    try:
        sharded = str(root / "sharded")
        world = run_world(root, 2, several,
                          (eval_cases, (data_root, sharded, params_path, SCENES, EVAL_KW)),
                          (forward_cases, ([(2, 1)], SIZE, tree, images, cams)))
        plain = str(root / "plain")
        with torch.backends.mkldnn.flags(enabled=False):
            run_eval_pc(data_root, plain, SCENES, params_path=params_path, device="cpu", **EVAL_KW)
            plies = [fuse_scene(os.path.join(plain, s), device="cpu") for s in SCENES]
            with torch.no_grad():
                single = {k: v.numpy() for k, v in
                          multi_view_forward_spmd(model, images, cams, PipelineConfig(**SIZE)).items()}
    finally:
        thread.join()
    return {"sharded": sharded, "plain": plain, "world": world, "plies": plies,
            "jax": jax_out, "single": single}


def _files(folder):
    return sorted(os.listdir(folder))


@pytest.mark.parametrize("scene", SCENES)
def test_sharded_eval_writes_the_same_maps(results, scene):
    ours, theirs = (os.path.join(results[k], scene, "depths_atvsnet") for k in ("sharded", "plain"))
    files = _files(theirs)
    assert _files(ours) == files
    assert {f"{v:08d}{s}" for v in range(3) for s in (".jpg", ".pfm", ".png", ".txt", "_prob.pfm")} <= set(files)
    for f in files:
        if f.endswith((".jpg", ".txt")):
            assert filecmp.cmp(os.path.join(ours, f), os.path.join(theirs, f), shallow=False), f
    for v in range(3):
        for suffix in (".pfm", "_prob.pfm"):
            got, want = (load_pfm(os.path.join(d, f"{v:08d}{suffix}")) for d in (ours, theirs))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert os.path.exists(os.path.join(results["sharded"], scene, "zz_runtime.txt"))


def test_rank0_fuses_after_every_rank_is_done(results):
    eval_result = results["world"][0][0]
    assert results["world"][1][0] is None           # only rank 0 fuses
    for got, want in zip(eval_result, results["plies"]):
        assert assert_same_cloud(read_ply(got), read_ply(want)) > 100


@pytest.mark.parametrize("key", KEYS)
def test_sharded_forward_on_data_2_matches(results, key):
    got = results["world"][0][1][(2, 1)][key]
    np.testing.assert_array_equal(got, results["world"][1][1][(2, 1)][key])
    volume = key == "refined_prob_volumes"
    np.testing.assert_allclose(got, results["single"][key],
                               **(dict(rtol=1e-4, atol=5e-4) if volume else dict(rtol=1e-5, atol=2e-5)))
    np.testing.assert_allclose(got, results["jax"][key],
                               **(dict(rtol=1e-4, atol=5e-4) if volume else dict(rtol=1e-3, atol=1e-4)))
