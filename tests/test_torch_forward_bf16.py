"""The port's bf16 forward against the JAX package's bf16 forward, on the CPU.

The scene ROADMAP.md measured the gap on: the trained spheres weights, 3 views, 64x96,
D=32, render_multiplane_scene(seed=11, num_spheres=2), compute_dtype="bfloat16" in both
(bf16 convolutions; geometry, normalization statistics and the soft-argmin in fp32).
Measured there: the final depth differs by 3.0e-4 on average and 1.03e-3 at most,
depth_views by 3.5e-3 at most (each package's bf16 is as far from its own fp32: bf16
rounding, not a fault). Bounds at about 3x that: final depth mean 1e-3 and max 3.1e-3,
depth_views max 1.05e-2, in sweep units. One JAX compile, cached for the module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.data.synthetic import render_multiplane_scene
from atvsnet_tpu.models.atvsnet import multi_view_forward as jax_forward
from atvsnet_tpu.utils.ckpt import load_params
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.params import load_model

torch.set_num_threads(2)

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=32, max_h=64, max_w=96, compute_dtype="bfloat16")
BOUNDS = {"depth": (1e-3, 3.1e-3), "depth_views": (None, 1.05e-2)}

_cache = {}


def outputs():
    if "bf16" not in _cache:
        s = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
        jcfg, cfg = JaxConfig(**SIZE), PipelineConfig(**SIZE)
        ref = jax.jit(lambda p, i, c: jax_forward(p, i, c, jcfg))(
            load_params(SPHERES), jnp.asarray(s["images"]), jnp.asarray(s["cams"]))
        got = multi_view_forward(load_model(SPHERES, cfg, device="cpu"), s["images"], s["cams"], cfg)
        _cache["bf16"] = ({k: np.asarray(v, np.float32) for k, v in ref.items()},
                          {k: v.float().numpy() for k, v in got.items()})
    return _cache["bf16"]


@pytest.mark.parametrize("key", list(BOUNDS))
def test_bf16_forward_matches_jax(key):
    ref, got = outputs()
    assert got[key].shape == ref[key].shape and np.isfinite(got[key]).all()
    diff = np.abs(got[key] - ref[key])
    mean_bound, max_bound = BOUNDS[key]
    assert diff.max() <= max_bound, diff.max()
    if mean_bound is not None:
        assert diff.mean() <= mean_bound, diff.mean()


def test_bf16_is_as_far_from_the_ports_fp32():
    """The same bound for the port's bf16 against its own fp32 (measured 2.8e-4 mean)."""
    _, got = outputs()
    s = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
    cfg = PipelineConfig(**dict(SIZE, compute_dtype="float32"))
    fp32 = multi_view_forward(load_model(SPHERES, cfg, device="cpu"), s["images"], s["cams"], cfg)
    assert np.abs(got["depth"] - fp32["depth"].numpy()).mean() <= BOUNDS["depth"][0]
