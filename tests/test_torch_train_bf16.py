"""bf16 training in the port against the JAX package's, on the CPU.

The batch of tests/test_torch_train.py: render_multiplane_scene(3 views, 32x64, D=8,
seed 3, 2 spheres) with the trained spheres weights and the default TrainConfig;
compute_dtype="bfloat16" in both packages, the default of both training CLIs. The JAX
side is one jit of value_and_grad(atvsnet_tpu.models.train.training_loss), cached for the
module; the port's is models.train.loss_and_grads under autograd, its soft-argmin on the
plain route (CPU tensors).

The yardstick is how far each package's own bf16 is from its own fp32, measured on this
batch (torch 2.13 CPU, any thread count: the port's bf16 loss and gradients are the same
at 1, 2, 4 and 6 threads):
  * loss, relative: the port 1.33e-3, JAX 4.15e-3; port against JAX in bf16 2.83e-3;
  * gradients, the global relative difference: the port 0.490, JAX 0.997; port against
    JAX in bf16 0.559. Over the 21 of 208 leaves whose bf16 gradient in the port is within
    0.1 of its fp32 one (the leaves well conditioned in bf16): the port 0.055, JAX 0.098;
    port against JAX 0.083.
bf16 gradients are that far from fp32 in both packages: batch norms follow every conv,
and their gradients are differences of nearly equal bf16 terms. JAX's is the farther
because its 3D convs sum the bf16 outputs of their three depth taps in bf16
(atvsnet_tpu/nn/layers.py _conv3d_decomposed), where the port's conv3d rounds once. The
gap between the packages lies between their own gaps: no fault in the port.

Bounds, about 3x the gap between the packages and no looser than JAX's own gap:
  * loss: rtol 4e-3 (3x is 8.5e-3);
  * gradients: 0.9 globally (3x is 1.68), 0.095 over the well-conditioned leaves
    (3x is 0.25).
Each test also checks the fault criterion on this run's numbers: the gap between the
packages may not exceed the larger of their own gaps. The port's fp32 stands in for JAX's
fp32 there (tests/test_torch_train.py holds the two to 2.1e-6 in the loss and 7.2e-4 in
the gradients).

oneDNN is off for this file, as in tests/test_torch_train.py: its CPU convolution
backward corrupted the heap with more than one thread (torch 2.13.0+cpu).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.config import TrainConfig as JaxTrainConfig
from atvsnet_tpu.data.synthetic import render_multiplane_scene
from atvsnet_tpu.models import train as jtrain
from atvsnet_tpu.utils.ckpt import load_params
from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.models import train as T
from atvsnet_torch.nn import layers as L
from atvsnet_torch.params import flatten, load_model

torch.set_num_threads(2)

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=8, max_h=32, max_w=64)
LOSS_RTOL = 4e-3
GRAD_BOUNDS = {"all": 0.9, "conditioned": 0.095}
CONDITIONED = 0.1        # the port's own bf16-vs-fp32 difference of a conditioned leaf


@pytest.fixture(autouse=True, scope="module")
def _onednn_off():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batch():
    s = render_multiplane_scene(view_num=3, H=32, W=64, D=8, seed=3, num_spheres=2)
    return {k: s[k] for k in ("images", "cams", "depth_gt")}


_cache = {}


def jax_bf16():
    if "jax" not in _cache:
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        jcfg = JaxConfig(**SIZE, compute_dtype="bfloat16")
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jtrain.training_loss(p, batch, jcfg, JaxTrainConfig()), has_aux=True))(
                load_params(SPHERES))
        _cache["jax"] = (float(loss), flatten(jax.tree_util.tree_map(
            lambda g: np.asarray(g, np.float32), grads)))
    return _cache["jax"]


def port(dtype):
    if dtype not in _cache:
        cfg = PipelineConfig(**SIZE, compute_dtype=dtype)
        model = load_model(SPHERES, cfg, device="cpu").requires_grad_(True)
        loss, metrics, grads = T.loss_and_grads(model, _batch(), cfg, TrainConfig())
        assert all(torch.isfinite(v) for v in metrics.values())
        _cache[dtype] = (float(loss), {
            n.replace(".", "/"): (L.torch_to_tf(g) if g.ndim > 2 else g).float().numpy()
            for n, g in grads.items()})
    return _cache[dtype]


def _global_rel(got, ref, keys):
    num = sum(float(np.square(got[k] - ref[k]).sum()) for k in keys)
    return (num / sum(float(np.square(ref[k]).sum()) for k in keys)) ** 0.5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_bf16_loss_matches_jax():
    jloss, _ = jax_bf16()
    loss, _ = port("bfloat16")
    loss32, _ = port("float32")
    gap = abs(loss - jloss) / abs(jloss)
    assert np.isfinite(loss) and gap <= LOSS_RTOL, gap
    own = max(abs(loss - loss32), abs(jloss - loss32)) / abs(loss32)
    assert gap <= own, (gap, own)


@pytest.mark.parametrize("leaves", list(GRAD_BOUNDS))
def test_bf16_gradients_match_jax(leaves):
    _, ref = jax_bf16()
    _, got = port("bfloat16")
    _, fp32 = port("float32")
    assert got.keys() == ref.keys() and all(np.isfinite(g).all() for g in got.values())
    keys = sorted(ref)
    if leaves == "conditioned":
        keys = [k for k in keys if _rel(got[k], fp32[k]) < CONDITIONED]
        assert len(keys) >= 10, keys
    gap = _global_rel(got, ref, keys)
    assert gap <= GRAD_BOUNDS[leaves], gap
    own = max(_global_rel(got, fp32, keys), _global_rel(ref, fp32, keys))
    assert gap <= own, (gap, own)
