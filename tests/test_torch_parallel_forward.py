"""The port's sharded forward (atvsnet_torch.parallel.pipeline.sharded_forward) on gloo
worlds of 4 processes on the CPU, meshes (1, 4) and (2, 2), against the port's forward
in one process and against the JAX package's jit_sharded_forward on the same shape of
virtual mesh (tests/conftest.py's 8 CPU devices).

5 views, 32x32, D=8 (tests/test_parallel.py's size), a batch of two different scenes, the
port's seeded random weights carried over to JAX by export_jax_params. Tolerances:
  * against the port in one process: depths rtol 1e-5, atol 2e-5 sweep units, refined
    volumes rtol 1e-4, atol 5e-4 (tests/test_torch_forward_mv5.py's stage tolerances): the
    ranks run each view's feature towers on a smaller batch and add AAM's view sums in
    another order, so only the rounding may differ;
  * against JAX: rtol 1e-3, atol 1e-4 on the depths, tests/test_parallel.py:80's bound
    for the sharded forward against one device, and the volumes at the same stage
    tolerances.
The (2, 1) mesh is held in tests/test_torch_parallel_eval.py, on its world of 2.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from atvsnet_tpu.parallel.pipeline import jit_sharded_forward
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.params import export_jax_params, init_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd

from tests._torch_world import forward_cases, run_world

SIZE = dict(view_num=5, max_d=8, max_h=32, max_w=32)
SHAPES = [(1, 4), (2, 2)]
KEYS = ("depth_agg_initial", "depth_views", "depth", "depth_up", "refined_prob_volumes")
DEPTH_TOL, VOLUME_TOL, JAX_DEPTH_TOL = (dict(rtol=1e-5, atol=2e-5), dict(rtol=1e-4, atol=5e-4),
                                        dict(rtol=1e-3, atol=1e-4))


def _batch():
    scenes = [synthetic_scene(view_num=5, H=32, W=32, D=8, seed=s) for s in (3, 5)]
    return (np.concatenate([i for i, _ in scenes]), np.concatenate([c for _, c in scenes]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The worlds' outputs, JAX's on each virtual mesh (compiled in threads while the world
    runs) and the port's in one process."""
    cfg = PipelineConfig(**SIZE)
    model = init_model(cfg, seed=0, device="cpu")
    tree = export_jax_params(model)
    images, cams = _batch()
    jax_out = {}

    def jax_forward(shape):
        out = jit_sharded_forward(jax_make_mesh(*shape), JaxConfig(**SIZE))(
            _unflatten(tree), jnp.asarray(images), jnp.asarray(cams))
        jax_out[shape] = {k: np.asarray(v) for k, v in out.items()}

    threads = [threading.Thread(target=jax_forward, args=(s,)) for s in SHAPES]
    for t in threads:
        t.start()
    try:
        world = run_world(tmp_path_factory.mktemp("forward"), 4, forward_cases, SHAPES, SIZE, tree,
                          images, cams)
    finally:
        for t in threads:
            t.join()
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        single = {k: v.numpy() for k, v in multi_view_forward_spmd(model, images, cams, cfg).items()}
    return world, jax_out, single


@pytest.mark.parametrize("shape", SHAPES)
def test_every_rank_gets_the_whole_batch(results, shape):
    world, _, single = results
    for rank in world:
        assert set(rank[shape]) == set(single)
        for k in single:
            assert rank[shape][k].shape == single[k].shape, k
            np.testing.assert_array_equal(rank[shape][k], world[0][shape][k], err_msg=k)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_forward_matches_one_process(results, shape, key):
    world, _, single = results
    tol = VOLUME_TOL if key == "refined_prob_volumes" else DEPTH_TOL
    np.testing.assert_allclose(world[0][shape][key], single[key], **tol)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_forward_matches_jax(results, shape, key):
    world, jax_out, _ = results
    tol = VOLUME_TOL if key == "refined_prob_volumes" else JAX_DEPTH_TOL
    np.testing.assert_allclose(world[0][shape][key], jax_out[shape][key], **tol)
