"""The port's multi_view_forward_spmd without a mesh (atvsnet_torch.parallel.pipeline)
against the JAX package's, on the CPU.

  * at tests/test_parallel.py's size (5 views, 32x32, D=8), with the port's seeded random
    weights carried over to the JAX package by export_jax_params, every output of one forward
    with the upsampled depth, at the stage tolerances of tests/test_torch_forward_mv5.py
    (volumes rtol 1e-4, atol 5e-4; depths rtol 1e-5, atol 2e-5 sweep units). The JAX
    forward with out_prob_map=True takes about a minute to compile here, so the
    confidence maps are held in tests/test_torch_parallel_serving.py instead;
  * under no_grad it equals models.atvsnet.multi_view_forward with pair_batch off to the
    bit on every output they share, as the training forward does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.parallel.pipeline import multi_view_forward_spmd as jax_spmd
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.params import export_jax_params, init_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd

torch.set_num_threads(2)

SIZE = dict(view_num=5, max_d=8, max_h=32, max_w=32)
VOLUME_TOL, DEPTH_TOL = dict(rtol=1e-4, atol=5e-4), dict(rtol=1e-5, atol=2e-5)
KEYS = {"depth_agg_initial": DEPTH_TOL, "depth_views": DEPTH_TOL, "depth": DEPTH_TOL,
        "depth_up": DEPTH_TOL, "refined_prob_volumes": VOLUME_TOL}

_cache = {}


def outputs():
    """(JAX outputs, the port's) at SIZE, one jit, computed once per module."""
    if "size" not in _cache:
        images, cams = synthetic_scene(view_num=5, H=32, W=32, D=8, seed=3)
        cfg = PipelineConfig(**SIZE)
        model = init_model(cfg, seed=0, device="cpu")
        jcfg, tree = JaxConfig(**SIZE), _unflatten(export_jax_params(model))
        ref = jax.jit(lambda p, i, c: jax_spmd(p, i, c, jcfg))(
            tree, jnp.asarray(images), jnp.asarray(cams))
        with torch.no_grad():
            got = multi_view_forward_spmd(model, images, cams, cfg)
        _cache["size"] = ({k: np.asarray(v) for k, v in ref.items()},
                          {k: v.numpy() for k, v in got.items()})
    return _cache["size"]


@pytest.mark.parametrize("key", list(KEYS))
def test_spmd_forward_matches_jax(key):
    ref, got = outputs()
    assert set(got) == set(ref)
    assert got[key].shape == ref[key].shape and np.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key], ref[key], **KEYS[key])


def test_spmd_forward_equals_multi_view_forward():
    cfg = PipelineConfig(**SIZE)
    model = init_model(cfg, seed=1, device="cpu")
    images, cams = synthetic_scene(view_num=5, H=32, W=32, D=8, seed=4)
    with torch.no_grad():
        spmd = multi_view_forward_spmd(model, images, cams, cfg, out_prob_map=True)
    ref = multi_view_forward(model, images, cams, cfg, out_prob_map=True)
    assert set(spmd) <= set(ref)
    for k in spmd:
        assert torch.equal(spmd[k], ref[k]), k
