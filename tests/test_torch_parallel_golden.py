"""The port's multi_view_forward_spmd against the committed golden output of the JAX
package's (tests/golden/golden_e2e.npz, case mv5_64_spmd of tools/make_golden.py: 5 views,
64x64, D=16, init_params(PRNGKey(0)) weights, synthetic_scene(seed=7)), fp32 on the CPU,
with the port's tolerance for depths at the golden sizes (rtol 1e-5, atol 2e-5 sweep
units; tests/test_torch_forward_mv5.py). Most of this file's time is the JAX package's
init_params, which runs op by op.
"""

import os

import jax
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.models.tvsnet import init_params
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.params import load_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_e2e.npz")
KW = dict(view_num=5, max_d=16, max_h=64, max_w=64)


@pytest.fixture(scope="module")
def depths():
    tree = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(0), JaxConfig(**KW)))
    cfg = PipelineConfig(**KW)
    images, cams = synthetic_scene(view_num=5, H=64, W=64, D=16, seed=7)
    with torch.no_grad():
        out = multi_view_forward_spmd(load_model(tree, cfg, device="cpu"), images, cams, cfg)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("key", ["depth", "depth_up"])
def test_spmd_forward_matches_golden(depths, key):
    with np.load(GOLDEN) as golden:
        want = golden[f"mv5_64_spmd/{key}"]
    assert depths[key].shape == want.shape
    np.testing.assert_allclose(depths[key], want, rtol=1e-5, atol=2e-5)
