"""The port on a (1, 1, 2) mesh, depth=2 alone, on a gloo world of 2 processes on the CPU.

The sharded forward (5 views, 32x32, D=16, the batch and seeded weights of
tests/test_torch_parallel_depth.py): both ranks get the same outputs to the bit; against
the port's forward in one process at that file's bounds, and against the JAX package's
multi_view_forward_spmd unsharded at tests/test_parallel.py:117-123's rtol 1e-3, atol
1e-4 on depth and depth_agg_initial; refined_prob_volumes comes back at the whole D.

The train step (models.train), fp32, against the step in one process. One batch of two rendered scenes (3 views, 32x32, D=16, render_multiplane_scene seeds 3 and
4, 2 spheres; the second row's ground truth ~70% zeroed) with the trained spheres
weights. Each depth rank holds 8 of the 16 planes of every volume (4, 2 and 1 at the
U-Nets' lower levels), exchanges halos, sums its statistics and merges its soft-argmins
over the group; the two ranks differentiate the same replicated loss and the world's
gradient sum is divided by n_depth.

Bounds, chip_smoke.py's for the sharded step (PERF.md §2 (g)): loss rtol 1e-4, gradients
within 5e-3 globally. At this size the one-process gradient is itself ill-conditioned: it
moves by 1.9e-3 globally between 1 and 4 threads (nearest rounding and visual-hull
comparisons flip on an ulp), and the depth split lands at the same distance (measured
1.8e-3). So per leaf only the stable ones are held, at 1e-2 of their norm: a leaf is
stable when the one-process gradients at 1 and at 2 threads differ by less than 1e-3 of
its norm (tests/test_torch_parallel_train.py's rule). After one sharded_train_step both
ranks hold the same parameters to the bit, and the stable leaves' update is as close to the
one-process step as that step is to itself at another thread count, within a factor 2.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.parallel.pipeline import multi_view_forward_spmd as jax_spmd
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.data.synthetic import render_multiplane_scene
from atvsnet_torch.models import train as T
from atvsnet_torch.params import export_jax_params, init_model, load_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd

from tests._torch_world import forward_cases, run_world, several, train_cases
from tests.test_torch_parallel_depth import (DEPTH_TOL, JAX_TOL, KEYS, VOLUME_TOL,
                                             SIZE as FORWARD_SIZE, _batch as _forward_batch)

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=16, max_h=32, max_w=32)
SHAPE = (1, 1, 2)
LOSS_RTOL, GRAD_REL, LEAF_REL = 1e-4, 5e-3, 1e-2


def _batch():
    scenes = [render_multiplane_scene(view_num=3, H=32, W=32, D=16, seed=s, num_spheres=2)
              for s in (3, 4)]
    batch = {k: np.concatenate([s[k] for s in scenes]) for k in ("images", "cams", "depth_gt")}
    drop = np.random.RandomState(0).rand(*batch["depth_gt"][1].shape) < 0.7
    batch["depth_gt"][1][drop] = 0.0
    return batch


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
            loss, _, grads = T.loss_and_grads(model, batch, cfg, tcfg)
            opt = T.make_optimizer(tcfg)
            state = T.init_train_state(load_model(SPHERES, cfg, device="cpu"), opt)
            state, _ = T.train_step(state, batch, cfg, tcfg, opt)
    finally:
        torch.set_num_threads(before)
    return (float(loss), {k: v.numpy() for k, v in grads.items()},
            {k: v.detach().numpy() for k, v in state.model.named_parameters()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The world's forward and train step, JAX's unsharded forward (compiled in a thread
    while the world runs), and the port's forward and step in one process."""
    batch = _batch()
    cfg = PipelineConfig(**FORWARD_SIZE)
    model = init_model(cfg, seed=0, device="cpu")
    tree = export_jax_params(model)
    images, cams = _forward_batch()
    jax_out = {}

    def jax_forward():
        out = jax.jit(lambda p, i, c: jax_spmd(p, i, c, JaxConfig(**FORWARD_SIZE)))(
            _unflatten(tree), jnp.asarray(images), jnp.asarray(cams))
        jax_out.update({k: np.asarray(v) for k, v in out.items()})

    thread = threading.Thread(target=jax_forward)
    thread.start()
    try:
        world = run_world(tmp_path_factory.mktemp("depth2"), 2, several,
                          (forward_cases, ([SHAPE], FORWARD_SIZE, tree, images, cams)),
                          (train_cases, ([SHAPE], SIZE, SPHERES, batch)))
    finally:
        thread.join()
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        forward = {k: v.numpy() for k, v in
                   multi_view_forward_spmd(model, images, cams, cfg).items()}
    single = _one_process(batch, threads=2)
    one_thread = _one_process(batch, threads=1)
    stable = [k for k in single[1] if _rel(single[1][k], one_thread[1][k]) < 1e-3]
    return ([r[1] for r in world], single, stable, one_thread[2],
            ([r[0][SHAPE] for r in world], jax_out, forward))


def test_every_depth_rank_gets_the_same_forward(results):
    ranks, _, single = results[4]
    for out in ranks:
        assert set(out) == set(single)
        for k in single:
            assert out[k].shape == single[k].shape, k
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("key", KEYS)
def test_depth2_forward_matches_one_process(results, key):
    ranks, _, single = results[4]
    tol = VOLUME_TOL if key == "refined_prob_volumes" else DEPTH_TOL
    np.testing.assert_allclose(ranks[0][key], single[key], **tol)


@pytest.mark.parametrize("key", ["depth", "depth_agg_initial"])
def test_depth2_forward_matches_jax(results, key):
    ranks, jax_out, _ = results[4]
    np.testing.assert_allclose(ranks[0][key], jax_out[key], **JAX_TOL)


def test_loss_and_gradients_match_one_process(results):
    world, (loss, grads, _), stable, *_ = results
    assert len(stable) > len(grads) // 2
    for rank in world:
        got = rank[SHAPE]
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got["metrics"]["loss"]), loss, rtol=LOSS_RTOL)
        assert got["grads"].keys() == grads.keys()
        assert all(np.isfinite(g).all() for g in got["grads"].values())
        assert _global_rel(got["grads"], grads) < GRAD_REL
        worst = max(stable, key=lambda k: _rel(got["grads"][k], grads[k]))
        assert _rel(got["grads"][worst], grads[worst]) < LEAF_REL, worst


def test_the_volume_nets_get_their_gradient_through_the_seams(results):
    """The CRM and the refine net run only on split volumes: without the halos' and the
    merges' backward, each rank would hold only its own planes' share."""
    world, (_, grads, _), stable, *_ = results
    nets = [k for k in grads if k.startswith(("crm.", "refine.")) and k in stable]
    assert nets
    got = world[0][SHAPE]["grads"]
    assert _global_rel({k: got[k] for k in nets}, {k: grads[k] for k in nets}) < GRAD_REL


def test_sharded_train_step_matches_one_process_step(results):
    world, (loss, _, params), stable, one_thread_params, _ = results
    start = {k: v.detach().numpy() for k, v in
             load_model(SPHERES, PipelineConfig(**SIZE), device="cpu").named_parameters()}
    for rank in world:
        np.testing.assert_allclose(float(rank[SHAPE]["step_metrics"]["loss"]), loss,
                                   rtol=LOSS_RTOL)
        for k in params:
            np.testing.assert_array_equal(rank[SHAPE]["params"][k], world[0][SHAPE]["params"][k])
    got = np.concatenate([(world[0][SHAPE]["params"][k] - start[k]).ravel() for k in stable])
    want = np.concatenate([(params[k] - start[k]).ravel() for k in stable])
    other = np.concatenate([(one_thread_params[k] - start[k]).ravel() for k in stable])
    # Adam's first step is g / (|g| + eps) element by element, so an element of the size of
    # the gradient's rounding may flip: the one-process step itself moves by 1.5e-2 of its
    # norm at 0.4% of its elements between 1 and 2 threads (the mesh's: 1.8e-2, 0.5%)
    assert _rel(got, want) <= 2 * _rel(other, want)
    assert np.mean(np.abs(got - want) > 1e-6) <= 2 * np.mean(np.abs(other - want) > 1e-6) + 1e-3
