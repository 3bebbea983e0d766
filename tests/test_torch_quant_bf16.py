"""The quantized forward in bf16, the port's against the JAX package's, on the CPU.

bench.py's default mode is bf16 with act_quant="int8s" and warp_quant="int8"; the case
act_quant="int8" alone is the dynamic-scale lattice. The scene and weights of
tests/test_torch_quant.py's quantized forward: synthetic_scene(5 views, 32x32, D=8,
seed 3), init_model(seed 0) carried over to JAX by export_jax_params; one JAX jit per
case, cached for the module. The links themselves are held in bf16 to the bit by
tests/test_torch_quant.py; this file holds the whole forward.

As in fp32, a value within rounding noise of a lattice tie lands one step apart in the
two packages, and the later links and refinement amplify that step: the chaos of the
ties sets the bound, not float noise. Measured (sweep units, mean / max over depth,
depth_agg_initial, depth_views; torch 2.13 CPU):
  * the port's own quantized bf16 forward when its images change by 1e-6 of their value:
    int8s + int8 1.8e-3 / 6.0e-3 on depth (2.7e-4 / 9.2e-4, 3.5e-4 / 7.4e-3 on the
    others), int8 6.0e-4 / 3.0e-3 (2.7e-4 / 9.6e-4, 4.0e-4 / 6.2e-3);
  * each package's quantized bf16 against its own quantized fp32 on depth: the port
    3.1e-3 / 9.0e-3 (int8s + int8) and 3.5e-3 / 1.1e-2 (int8), JAX 2.8e-3 / 9.0e-3 and
    2.6e-3 / 9.3e-3;
  * the port against JAX: int8s + int8 depth 2.1e-3 / 6.4e-3, depth_agg_initial
    7.9e-4 / 3.3e-3, depth_views 1.6e-3 / 9.3e-3; int8 depth 2.2e-3 / 1.5e-2,
    depth_agg_initial 9.8e-4 / 2.7e-3, depth_views 1.7e-3 / 6.8e-3.
Bounds: mean 6e-3 and max 4.5e-2 sweep units on each output, about 3x the largest
measured gap (the sweep interval is 0.05, so the max is one plane at one pixel, the mean
an eighth of a plane).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.models.atvsnet import multi_view_forward as jax_forward
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.params import export_jax_params, init_model

torch.set_num_threads(2)

SIZE = dict(view_num=5, max_d=8, max_h=32, max_w=32, compute_dtype="bfloat16")
CASES = {"int8s_warp_int8": dict(act_quant="int8s", warp_quant="int8"),
         "int8": dict(act_quant="int8")}
KEYS = ("depth", "depth_agg_initial", "depth_views")
FORWARD_MEAN, FORWARD_MAX = 6e-3, 4.5e-2

_cache = {}


def _scene():
    if "scene" not in _cache:
        images, cams = synthetic_scene(view_num=5, H=32, W=32, D=8, seed=3)
        model = init_model(PipelineConfig(**SIZE), seed=0, device="cpu")
        _cache["scene"] = images, cams, model, _unflatten(export_jax_params(model))
    return _cache["scene"]


def _port(images, **quant):
    _, cams, model, _ = _scene()
    cfg = PipelineConfig(**SIZE, **quant)
    return {k: v.float().numpy() for k, v in multi_view_forward(model, images, cams, cfg).items()}


def forwards(case):
    """(JAX's outputs, the port's, the port's unquantized) in bf16, as fp32 numpy."""
    if case not in _cache:
        images, cams, _, tree = _scene()
        jcfg = JaxConfig(**SIZE, **CASES[case])
        ref = jax.jit(lambda p, i, c: jax_forward(p, i, c, jcfg))(
            tree, jnp.asarray(images), jnp.asarray(cams))
        _cache[case] = ({k: np.asarray(ref[k], np.float32) for k in KEYS},
                        _port(images, **CASES[case]), _port(images))
    return _cache[case]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_bf16_forward_matches_jax(case, key):
    ref, got, plain = forwards(case)
    assert got[key].shape == ref[key].shape and np.isfinite(got[key]).all()
    diff = np.abs(got[key] - ref[key])
    assert diff.mean() <= FORWARD_MEAN and diff.max() <= FORWARD_MAX, (diff.mean(), diff.max())
    assert np.abs(plain[key] - got[key]).max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_the_ports_own_move_under_image_noise(case):
    """The chaos the bound allows for: the port's own quantized bf16 forward moves when
    its images change by 1e-6 of their value, and stays within the bounds."""
    _, got, _ = forwards(case)
    images = _scene()[0]
    noise = np.random.RandomState(7).randn(*images.shape)
    moved = _port((images * (1 + 1e-6 * noise)).astype(np.float32), **CASES[case])
    for key in KEYS:
        diff = np.abs(moved[key] - got[key])
        assert diff.mean() <= FORWARD_MEAN and diff.max() <= FORWARD_MAX, (key, diff.max())
    assert np.abs(moved["depth"] - got["depth"]).max() > 0
