"""The port's sharded train step (atvsnet_torch.models.train with a mesh) on a gloo world
of 2 processes on the CPU, meshes (2, 1) and (1, 2), fp32.

One batch of two rendered scenes (3 views, 32x32, D=8, render_multiplane_scene seeds 3
and 4, 2 spheres) with the trained spheres weights; the second row's ground truth has
~70% of its pixels zeroed, so the two data ranks hold very different valid counts and
a mean of per-rank losses would be wrong. Held against:
  * the port's loss_and_grads and train_step on the whole batch in one process: loss
    rtol 1e-5; gradients within 1e-4 globally (the ranks cut every sum over the batch and
    over views in two and add them in another order; measured ~1e-6); on (1, 2), every
    leaf of the CRM, which only stage 1 uses, within 1e-3 of its own norm where it is
    stable (below), so the gradient must come back through AAM1's collectives;
  * the JAX package's value_and_grad of training_loss on a (1, 2) virtual mesh, sharded
    as jit_sharded_train_step shards it (parameters replicated, the batch over 'data'):
    loss rtol 1e-5, gradients within 5e-3 globally and within 1e-2 on every stable leaf,
    the bounds of tests/test_torch_train.py. Both port meshes are held against this one
    JAX program: its compile alone takes ~25 s here.
A leaf is stable when the port's one-process gradient at 1 and at 2 threads differ by less
than 1e-3 of its norm (tests/test_torch_train.py: biases before a batch norm and
refinement's rounding make a few leaves move on an ulp). After one sharded_train_step
the ranks hold the same parameters to the bit, and the stable leaves' update is the
one-process step's: at most 0.1% of its elements differ by more than 1e-6, and the
whole within 1e-2 of its norm (Adam's first step divides each element by its own size).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.config import TrainConfig as JaxTrainConfig
from atvsnet_tpu.models import train as jtrain
from atvsnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from atvsnet_tpu.utils.ckpt import load_params
from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.data.synthetic import render_multiplane_scene
from atvsnet_torch.models import train as T
from atvsnet_torch.nn import layers as L
from atvsnet_torch.params import flatten, load_model

from tests._torch_world import run_world, train_cases

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=8, max_h=32, max_w=32)
SHAPES = [(2, 1), (1, 2)]


def _batch():
    scenes = [render_multiplane_scene(view_num=3, H=32, W=32, D=8, seed=s, num_spheres=2)
              for s in (3, 4)]
    batch = {k: np.concatenate([s[k] for s in scenes]) for k in ("images", "cams", "depth_gt")}
    drop = np.random.RandomState(0).rand(*batch["depth_gt"][1].shape) < 0.7
    batch["depth_gt"][1][drop] = 0.0
    return batch


def _tf(name, g):
    """A port gradient as the JAX package's flat tree holds it (TF kernel layouts)."""
    return name.replace(".", "/"), (L.torch_to_tf(torch.from_numpy(g)).numpy() if g.ndim > 2 else g)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _global_rel(got, ref):
    num = sum(float(np.square(got[k] - ref[k]).sum()) for k in ref)
    return (num / sum(float(np.square(ref[k]).sum()) for k in ref)) ** 0.5


def _one_process(batch, threads):
    cfg, tcfg = PipelineConfig(**SIZE), TrainConfig()
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            model = load_model(SPHERES, cfg, device="cpu").requires_grad_(True)
            loss, metrics, grads = T.loss_and_grads(model, batch, cfg, tcfg)
            opt = T.make_optimizer(tcfg)
            state = T.init_train_state(load_model(SPHERES, cfg, device="cpu"), opt)
            state, _ = T.train_step(state, batch, cfg, tcfg, opt)
    finally:
        torch.set_num_threads(before)
    return (float(loss), {k: v.numpy() for k, v in grads.items()},
            {k: v.detach().numpy() for k, v in state.model.named_parameters()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    batch = _batch()
    jax_out = {}

    def jax_reference():
        mesh = jax_make_mesh(1, 2)
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        data = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
        jcfg, jtcfg = JaxConfig(**SIZE), JaxTrainConfig()
        fn = jax.jit(lambda p, b: jax.value_and_grad(
            lambda q: jtrain.training_loss(q, b, jcfg, jtcfg, mesh), has_aux=True)(p),
            in_shardings=(repl, {k: data for k in batch}))
        (loss, _), grads = fn(load_params(SPHERES), {k: jnp.asarray(v) for k, v in batch.items()})
        jax_out["loss"] = float(loss)
        jax_out["grads"] = flatten(jax.tree_util.tree_map(np.asarray, grads))

    thread = threading.Thread(target=jax_reference)
    thread.start()
    try:
        world = run_world(tmp_path_factory.mktemp("train"), 2, train_cases, SHAPES, SIZE,
                          SPHERES, batch)
        single = _one_process(batch, threads=2)
        one_thread = _one_process(batch, threads=1)
    finally:
        thread.join()
    stable = [k for k in single[1] if _rel(single[1][k], one_thread[1][k]) < 1e-3]
    return world, single, jax_out, stable


def test_gt_density_differs_between_the_rows():
    valid = (_batch()["depth_gt"] > 0).reshape(2, -1).mean(axis=1)
    assert valid[0] > 2 * valid[1] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_loss_and_gradients_match_one_process(results, shape):
    world, (loss, grads, _), _, _ = results
    for rank in world:
        got = rank[shape]
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(got["metrics"]["loss"]), loss, rtol=1e-5)
        assert got["grads"].keys() == grads.keys()
        assert all(np.isfinite(g).all() for g in got["grads"].values())
        assert _global_rel(got["grads"], grads) < 1e-4


def test_stage1_parameters_get_the_one_process_gradient(results):
    world, (_, grads, _), _, stable = results
    crm = [k for k in grads if k.startswith("crm.")]
    assert len([k for k in crm if k in stable]) > len(crm) // 2
    for rank in world:
        got = rank[(1, 2)]["grads"]
        assert _global_rel({k: got[k] for k in crm}, {k: grads[k] for k in crm}) < 1e-4
        for k in crm:
            if k in stable:
                assert _rel(got[k], grads[k]) < 1e-3, k


@pytest.mark.parametrize("shape", SHAPES)
def test_loss_and_gradients_match_jax(results, shape):
    world, _, jax_out, stable = results
    got = dict(_tf(k, g) for k, g in world[0][shape]["grads"].items())
    ref = jax_out["grads"]
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(float(world[0][shape]["loss"]), jax_out["loss"], rtol=1e-5)
    assert _global_rel(got, ref) < 5e-3
    stable_tf = [_tf(k, np.zeros(1))[0] for k in stable]
    assert len(stable_tf) > len(ref) // 2
    worst = max(stable_tf, key=lambda k: _rel(got[k], ref[k]))
    assert _rel(got[worst], ref[worst]) < 1e-2, worst


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_train_step_matches_one_process_step(results, shape):
    world, (loss, _, params), _, stable = results
    start = {k: v.detach().numpy() for k, v in
             load_model(SPHERES, PipelineConfig(**SIZE), device="cpu").named_parameters()}
    for rank in world:
        np.testing.assert_allclose(float(rank[shape]["step_metrics"]["loss"]), loss, rtol=1e-5)
        for k in params:
            np.testing.assert_array_equal(rank[shape]["params"][k], world[0][shape]["params"][k])
    # Adam's first step is g / (|g| + eps) element by element: a gradient element of the
    # size of its rounding may flip, so the updates are held over all stable leaves at once
    got = np.concatenate([(world[0][shape]["params"][k] - start[k]).ravel() for k in stable])
    want = np.concatenate([(params[k] - start[k]).ravel() for k in stable])
    assert np.mean(np.abs(got - want) > 1e-6) < 1e-3
    assert _rel(got, want) < 1e-2
