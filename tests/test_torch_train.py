"""Training in the port against the JAX package (CPU): losses, gradients, the optimizer.

One seeded batch: render_multiplane_scene(3 views, 32x64, D=8, seed 3, 2 spheres) with
the trained spheres weights (artifacts/trained_demo/spheres_params.npz). The JAX
references are jax.value_and_grad of atvsnet_tpu.models.train.training_loss, one jit
each, computed once per module: (a) the aggregated and per-pair terms alone
(loss_weight_refined=0), (b) the whole default loss, (c) the whole loss with the
confidence term (weight 0.5) on a batch with depth_views_gt (the multi-depth branch).

Bounds, each with the value measured when it was set (torch 2.13 CPU, 4 threads):
  * loss: rtol 1e-5 (measured 2.3e-6, 2.1e-6, 6.6e-7).
  * (a): every leaf within 1e-2 of its own norm plus 1e-6 of the global norm (the
    biases of the convs that feed a batch norm have gradients of ~1e-8, pure rounding,
    which the second term covers); the global relative difference within 2e-3
    (measured 7.0e-4; worst leaf fem/conv1_x_4/preact/beta at 4.4e-3).
  * (b), (c): the global relative difference within 5e-3 (measured 7.2e-4, 7.0e-4). A
    per-leaf bound of 1e-2 holds for the leaves whose own gradient is stable under a
    change of summation order, which the test measures: the same loss at
    torch.set_num_threads(1) and (4); stable means those two differ by less than 1e-3 of
    the leaf's norm (203 of 208 leaves; the five others include the biases above; the
    worst stable leaf measured at 4.4e-3 and 3.6e-3 against JAX). Refinement's nearest
    rounding and visual-hull comparisons, and the normalizations after a bias, make a
    few leaves ill-conditioned: an ulp in the forward moves their gradient.
  * every gradient is finite.
The optimizer is held to optax at rtol 1e-6 over 6 steps on identical gradients.

oneDNN is switched off for this file's tests: its CPU convolution backward corrupted the
heap with more than one thread (torch 2.13.0+cpu; "corrupted size vs. prev_size" on the
second training step of this batch). PyTorch's own convolutions give the same values.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.config import TrainConfig as JaxTrainConfig
from atvsnet_tpu.data.synthetic import render_multiplane_scene, synthetic_scene
from atvsnet_tpu.models import train as jtrain
from atvsnet_tpu.nn import blocks as jblocks
from atvsnet_tpu.nn import layers as jlayers
from atvsnet_tpu.utils.ckpt import load_params
from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.data.synthetic import make_cam
from atvsnet_torch.models.atvsnet import multi_view_forward, multi_view_forward_train
from atvsnet_torch.models import train as T
from atvsnet_torch.nn import layers as L
from atvsnet_torch.nn.blocks import Bottleneck
from atvsnet_torch.ops import softargmin as S
from atvsnet_torch.params import flatten, load_model

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=8, max_h=32, max_w=64)
CASES = {
    "agg_aux": dict(loss_weight_refined=0.0),
    "full": {},
    "conf_views": dict(loss_weight_confidence=0.5),
}


def _batch(case):
    s = render_multiplane_scene(view_num=3, H=32, W=64, D=8, seed=3, num_spheres=2)
    batch = {k: s[k] for k in ("images", "cams", "depth_gt")}
    if case == "conf_views":
        rng = np.random.RandomState(5)
        views = 0.5 + 0.5 * rng.rand(1, 2, 8, 16, 1)
        batch["depth_views_gt"] = np.where(rng.rand(*views.shape) < 0.1, 0.0, views).astype(np.float32)
    return batch


def _tf_grads(grads):
    """The port's gradients as the JAX package's flat tree (TF kernel layouts)."""
    return {n.replace(".", "/"): (L.torch_to_tf(g) if g.ndim > 2 else g).numpy()
            for n, g in grads.items()}


_jax_cache, _port_cache = {}, {}

@pytest.fixture(autouse=True, scope="module")
def _onednn_off():
    """oneDNN off for this file's tests only (see the module docstring)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def jax_reference(case):
    if case not in _jax_cache:
        batch = {k: jnp.asarray(v) for k, v in _batch(case).items()}
        jcfg, jtcfg = JaxConfig(**SIZE), JaxTrainConfig(**CASES[case])
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jtrain.training_loss(p, batch, jcfg, jtcfg), has_aux=True))(load_params(SPHERES))
        _jax_cache[case] = (float(loss), {k: float(v) for k, v in metrics.items()},
                            flatten(jax.tree_util.tree_map(np.asarray, grads)))
    return _jax_cache[case]


def port_result(case, threads=4, **cfg_kw):
    key = (case, threads, tuple(sorted(cfg_kw.items())))
    if key not in _port_cache:
        cfg = PipelineConfig(**SIZE, **cfg_kw)
        model = load_model(SPHERES, cfg, device="cpu").requires_grad_(True)
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            loss, metrics, grads = T.loss_and_grads(model, _batch(case), cfg, TrainConfig(**CASES[case]))
        finally:
            torch.set_num_threads(before)
        _port_cache[key] = (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
                            _tf_grads(grads))
    return _port_cache[key]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _global_rel(got, ref):
    num = sum(float(np.square(got[k] - ref[k]).sum()) for k in ref)
    return (num / sum(float(np.square(ref[k]).sum()) for k in ref)) ** 0.5


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_metrics_match_jax(case):
    jloss, jmetrics, _ = jax_reference(case)
    loss, metrics, grads = port_result(case)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert metrics.keys() == jmetrics.keys()
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, err_msg=k)
    assert all(np.isfinite(g).all() for g in grads.values())


def test_agg_and_aux_gradients_match_jax_per_leaf():
    _, _, ref = jax_reference("agg_aux")
    _, _, got = port_result("agg_aux")
    assert got.keys() == ref.keys()
    total = np.sqrt(sum(float(np.square(g).sum()) for g in ref.values()))
    for k in ref:
        assert np.isfinite(got[k]).all(), k
        diff = float(np.linalg.norm(got[k] - ref[k]))
        assert diff <= 1e-2 * np.linalg.norm(ref[k]) + 1e-6 * total, (k, diff)
    assert _global_rel(got, ref) < 2e-3


@pytest.mark.parametrize("case", ["full", "conf_views"])
def test_whole_loss_gradients_match_jax(case):
    _, _, ref = jax_reference(case)
    _, _, got = port_result(case, threads=4)
    _, _, one_thread = port_result(case, threads=1)
    assert all(np.isfinite(g).all() for g in got.values())
    assert _global_rel(got, ref) < 5e-3
    stable = [k for k in ref if _rel(got[k], one_thread[k]) < 1e-3]
    assert len(stable) > len(ref) // 2, f"only {len(stable)} of {len(ref)} leaves are stable"
    worst = max(stable, key=lambda k: _rel(got[k], ref[k]))
    assert _rel(got[worst], ref[worst]) < 1e-2, worst
    # the one parameter no loss term reaches: exactly 0 in both
    np.testing.assert_array_equal(got["refine/global_refined_cost_vol/w"], 0.0)
    np.testing.assert_array_equal(ref["refine/global_refined_cost_vol/w"], 0.0)


def test_remat_matches_no_remat():
    """torch.utils.checkpoint recomputes the same values: the loss is equal to the bit, and
    the gradients may differ only by the order in which autograd accumulates the pairs'
    contributions to shared weights (bound: global relative difference 1e-6; measured 0)."""
    loss, _, plain = port_result("full")
    loss_r, _, remat = port_result("full", remat=True)
    assert loss_r == loss
    assert _global_rel(remat, plain) < 1e-6


@pytest.mark.parametrize("remat,conf,expected", [(False, 0.0, (4, 4)), (True, 0.0, (6, 4)),
                                                 (False, 0.5, (3, 3)), (True, 0.5, (5, 3))])
def test_kernel_route_calls_per_loss(monkeypatch, remat, conf, expected):
    """The training forward's soft-argmins on the kernel route, counted through the two
    kernel launchers, stood in for by their counted plain versions (the forward with its
    statistics, the stats-fed backward at offset 0): per pair one stage-1
    call, AAM1's, and the final depth's unless the confidence term sends it to the plain
    confidence formula; remat recomputes stage 1 in the backward. The same counts are
    asserted for the kernels on the card."""
    calls = {"forward": 0, "backward": 0}
    fwd = S.softargmin_torch

    def bwd(cost, start, interval, stats, depth, grad):
        return S.softargmin_backward_stats_torch(cost, start, interval, 0, stats, depth, grad)

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(S, "softargmin_cuda", counted("forward", fwd))
    monkeypatch.setattr(S, "softargmin_backward_cuda", counted("backward", bwd))
    cfg = PipelineConfig(**SIZE, remat=remat, softargmin_impl="cuda")
    model = load_model(SPHERES, cfg, device="cpu").requires_grad_(True)
    loss, _, grads = T.loss_and_grads(model, _batch("full"), cfg,
                                      TrainConfig(loss_weight_confidence=conf))
    assert (calls["forward"], calls["backward"]) == expected
    assert np.isfinite(float(loss.detach()))


@pytest.mark.parametrize("remat,out_prob_map", [(False, False), (True, True)])
def test_train_forward_equals_serving_forward(remat, out_prob_map):
    """multi_view_forward_train and multi_view_forward are two entry points of one stage
    sequence (models.atvsnet.forward_stages; the training one without the reference
    direction's depths and the served outputs, with remat while autograd records): under
    no_grad, with pair_batch off, the two give the same outputs to the bit."""
    cfg = PipelineConfig(**SIZE, remat=remat, pair_batch=False)
    model = load_model(SPHERES, cfg, device="cpu")
    b = _batch("full")
    with torch.no_grad():
        train = multi_view_forward_train(model, b["images"], b["cams"], cfg, out_prob_map)
    serve = multi_view_forward(model, b["images"], b["cams"], cfg, out_prob_map, upsample=False)
    keys = ["depth_agg_initial", "depth_views", "refined_prob_volumes", "depth"]
    assert set(train) == set(keys + ["confidence"] * out_prob_map)
    for k in train:
        assert torch.equal(train[k], serve[k]), k


def test_masked_l1_matches_jax():
    rng = np.random.RandomState(0)
    pred, gt = rng.rand(2, 6, 7, 1).astype(np.float32), rng.rand(2, 6, 7, 1).astype(np.float32)
    gt[gt < 0.3] = 0.0
    mask = (rng.rand(2, 6, 7, 1) > 0.2).astype(np.float32)
    interval = np.array([0.05, 0.02], np.float32)
    for extra in (None, mask):
        ref = jtrain.masked_l1(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(interval),
                               None if extra is None else jnp.asarray(extra))
        got = T.masked_l1(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(interval),
                          None if extra is None else torch.from_numpy(extra))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    zero = T.masked_l1(torch.ones(1, 2, 2, 1), torch.zeros(1, 2, 2, 1), torch.ones(1))
    assert float(zero) == 0.0


def test_aux_view_loss_zero_for_consistent_depths():
    """The JAX package's rig: a lateral translation and a constant-depth plane, so the view
    depths equal the ground truth in every frame and the term is exactly 0."""
    K = np.array([[8.0, 0.0, 4.0], [0.0, 8.0, 4.0], [0.0, 0.0, 1.0]])
    cams = np.stack([make_cam(K, np.eye(3), np.array([0.2 * v, 0.0, 0.0]), depth_start=0.5,
                              depth_interval=0.05, num_d=8) for v in range(3)])[None]
    gt = np.full((1, 8, 8, 1), 0.8, np.float32)
    views = np.full((2, 1, 8, 8, 1), 0.8, np.float32)
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    aux = T.aux_view_loss(torch.from_numpy(views), torch.from_numpy(cams.astype(np.float32)),
                          torch.from_numpy(gt), torch.tensor([0.05]), cfg)
    assert float(aux) == 0.0


def test_aux_view_loss_value_and_gradient_match_jax():
    _, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=2)
    rng = np.random.RandomState(1)
    gt = (0.55 + 0.3 * rng.rand(1, 8, 8, 1)).astype(np.float32)
    views = (0.55 + 0.3 * rng.rand(2, 1, 8, 8, 1)).astype(np.float32)
    interval = np.array([0.05], np.float32)
    jcfg, cfg = JaxConfig(view_num=3, max_d=8, max_h=32, max_w=32), PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    ref, ref_grad = jax.value_and_grad(lambda v: jtrain.aux_view_loss(
        v, jnp.asarray(cams), jnp.asarray(gt), jnp.asarray(interval), jcfg))(jnp.asarray(views))
    v = torch.from_numpy(views).requires_grad_(True)
    got = T.aux_view_loss(v, torch.from_numpy(cams), torch.from_numpy(gt), torch.from_numpy(interval), cfg)
    got.backward()
    assert float(got.detach()) > 0.1
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-7)


def _tie_cases():
    """Inputs whose normalized pre-activations are exact zeros: a 1x1 conv of a map that
    is constant over space with dyadic weights (the batch mean is exact, so x - mean is
    0 at every pixel), and a bottleneck whose input is constant per channel."""
    x = np.ones((1, 4, 4, 2), np.float32)
    w = np.array([[[[0.5, -1.0, 0.25], [1.0, 0.5, -0.5]]]], np.float32)   # TF (1, 1, 2, 3)
    x_block = np.broadcast_to(np.array([1.0, -2.0, 0.5, 3.0], np.float32), (1, 4, 4, 4)).copy()
    r = np.random.RandomState(0).randn(1, 4, 4, 3).astype(np.float32)
    return x, w, x_block, r


def test_activation_ties_follow_jnp_maximum(monkeypatch):
    """At exact zeros jnp.maximum(y, 0) sends half the gradient on; the port's activation
    does the same, and the forward values are relu's. torch.relu would send none: with
    it the gradients below come out different (0 where JAX has half)."""
    x, w, x_block, r = _tie_cases()
    cin = x_block.shape[-1]

    def jax_grads():
        def conv_loss(x, w):
            return jnp.sum(jlayers.conv_bn({"w": w}, x) * r)
        g_conv = jax.grad(conv_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        params = {"preact": {"beta": jnp.zeros(cin)}, "conv1": {"w": jnp.full((1, 1, cin, 3), 0.5), "b": jnp.zeros(3)},
                  "conv2": {"w": jnp.full((3, 3, 3, 3), 0.25), "b": jnp.zeros(3)},
                  "conv3": {"w": jnp.full((1, 1, 3, 3), 0.5), "b": jnp.zeros(3)},
                  "shortcut": {"w": jnp.full((1, 1, cin, 3), 0.5), "b": jnp.zeros(3)}}
        g_block = jax.grad(lambda x, p: jnp.sum(jblocks.bottleneck(p, x) * r), argnums=(0, 1))(
            jnp.asarray(x_block), params)
        return ([np.asarray(a) for a in g_conv],
                [np.asarray(g_block[0]), np.asarray(g_block[1]["preact"]["beta"])])

    def port_grads():
        xt, wt = torch.from_numpy(x).requires_grad_(True), L.tf_to_torch(torch.from_numpy(w)).requires_grad_(True)
        y = L.conv_bn(xt, wt)
        assert bool((y == 0).all())                       # every pre-activation is a tie
        (y * torch.from_numpy(r)).sum().backward()
        block = Bottleneck(cin, 3)
        with torch.no_grad():
            for conv, value in ((block.conv1, 0.5), (block.conv2, 0.25), (block.conv3, 0.5),
                                (block.shortcut, 0.5)):
                conv.w.fill_(value)
                conv.b.zero_()
        xb = torch.from_numpy(x_block).requires_grad_(True)
        (block(xb) * torch.from_numpy(r)).sum().backward()
        return ([xt.grad.numpy(), L.torch_to_tf(wt.grad).numpy()],
                [xb.grad.numpy(), block.preact.beta.grad.numpy()])

    (j_conv, j_block), (p_conv, p_block) = jax_grads(), port_grads()
    assert np.abs(j_conv[0]).max() > 0 and np.abs(j_block[1]).max() > 0
    # the conv weight's gradient sums a constant input against a zero-mean map: 0 up to
    # rounding (~1e-5) in both, so only the input's and the block's gradients are compared
    assert np.abs(p_conv[1]).max() < 1e-4 and np.abs(j_conv[1]).max() < 1e-4
    for got, ref in zip(p_conv[:1] + p_block, j_conv[:1] + j_block):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the tie rule is what decides it: torch.relu gives other gradients
    monkeypatch.setattr(L, "activate", torch.relu)
    relu_conv, relu_block = port_grads()
    assert not np.allclose(relu_conv[0], j_conv[0], atol=1e-3)
    assert not np.allclose(relu_block[1], j_block[1], atol=1e-3)


def _tiny_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"a/w": rng.randn(3, 3, 2, 4).astype(np.float32), "a/b": rng.randn(4).astype(np.float32),
            "c": rng.randn(5).astype(np.float32), "d/e/w": rng.randn(2, 6).astype(np.float32)}


def _tiny_model(arrays):
    root = torch.nn.Module()
    for path, arr in arrays.items():
        mod = root
        *parents, leaf = path.split("/")
        for p in parents:
            if not hasattr(mod, p):
                mod.add_module(p, torch.nn.Module())
            mod = getattr(mod, p)
        mod.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(arr.copy())))
    return root


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        *parents, leaf = path.split("/")
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("kw", [dict(learning_rate=1e-2, weight_decay=1e-2),
                                dict(learning_rate=1e-2, weight_decay=1e-2, lr_schedule="cosine",
                                     warmup_steps=2, decay_steps=5, lr_final_fraction=0.1)],
                         ids=["constant", "cosine_warmup"])
def test_optimizer_matches_optax(kw):
    """make_optimizer's chain (clip at 1.0, weight decay, Adam) on identical gradients over
    6 steps: the global norms alternate about 0.4 and 4 so that clipping acts on every
    other step; the cosine case runs past its horizon. rtol 1e-6 on params, moments."""
    arrays = _tiny_params()
    tcfg = TrainConfig(**kw)
    tx = jtrain.make_optimizer(JaxTrainConfig(**kw))
    jparams = _nest(arrays)
    jstate = tx.init(jparams)
    model = _tiny_model(arrays)
    opt = T.make_optimizer(tcfg)
    state = opt.init(model)
    rng = np.random.RandomState(1)
    update = jax.jit(tx.update)
    for step in range(6):
        scale = 0.2 if step % 2 == 0 else 2.0
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32) for k, v in arrays.items()}
        updates, jstate = update(_nest(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = opt.apply(model, {k.replace("/", "."): torch.from_numpy(g) for k, g in grads.items()},
                          state)
        ref = flatten(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name.replace(".", "/")],
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {step} {name}")
    adam = next(s for s in jax.tree_util.tree_leaves(jstate, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))
    assert state.count == int(adam.count) == 6
    mu = flatten(jax.tree_util.tree_map(np.asarray, adam.mu))
    for name in state.mu:
        np.testing.assert_allclose(state.mu[name].numpy(), mu[name.replace(".", "/")], rtol=1e-6,
                                   atol=1e-8)


def test_learning_rate_schedule_matches_optax():
    kw = dict(learning_rate=3e-3, lr_schedule="cosine", warmup_steps=3, decay_steps=11,
              lr_final_fraction=0.05)
    opt = T.make_optimizer(TrainConfig(**kw))
    sched = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=3e-3, warmup_steps=3,
                                               decay_steps=11, end_value=3e-3 * 0.05)
    for count in range(15):
        # two float32 ulps: numpy's and XLA's float32 cosines may differ by one
        np.testing.assert_allclose(opt.learning_rate(count), float(sched(count)), rtol=2.4e-7,
                                   err_msg=str(count))
    assert T.make_optimizer(TrainConfig(learning_rate=2e-3)).learning_rate(7) == np.float32(2e-3)


def test_train_config_matches_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert {f.name: f.default for f in dataclasses.fields(TrainConfig)} == jfields
    for bad in ({"lr_schedule": "step"}, {"decay_steps": 0}, {"warmup_steps": -1},
                {"loss_weight_confidence": -1.0},
                {"lr_schedule": "cosine", "warmup_steps": 10, "decay_steps": 10}):
        with pytest.raises(ValueError):
            JaxTrainConfig(**bad)
        with pytest.raises(ValueError):
            TrainConfig(**bad)


def test_train_step_advances_the_state():
    cfg = PipelineConfig(**SIZE)
    model = load_model(SPHERES, cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())   # load_model freezes
    opt = T.make_optimizer(TrainConfig())
    state = T.init_train_state(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = T.train_step(state, _batch("full"), cfg, TrainConfig(), opt)
    assert state.step == 1 and state.opt_state.count == 1
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["loss_aux"]))
    # every parameter moves but four whose gradient is exactly 0 at this size, in JAX too:
    # the SPP branches' convs (their pools cover the whole 8x16 feature map, so each conv
    # sees a constant map, which the normalization turns into zeros) and the refine net's
    # global_refined_cost_vol, which no loss term reaches
    still = {n for n, p in model.named_parameters() if torch.equal(p, before[n])}
    assert still == {"fem.branch_0_conv.w", "fem.branch_1_conv.w", "fem.branch_2_conv.w",
                     "refine.global_refined_cost_vol.w"}
