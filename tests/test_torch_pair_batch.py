"""cfg.pair_batch in the port: stacked sweeps through one set of convs.

The JAX package threads a `groups` / `bn_groups` argument down to batch_stat_norm and
ignores it there, because the statistics are per sample already. The port therefore has
no such argument: a stacked batch goes through the layers as it is. Held here:

  * batch_stat_norm, the CRM and the refine net on a stacked batch equal the per-element
    calls, and equal the JAX layers called with groups / bn_groups = 2;
  * multi_view_forward with pair_batch=True against the JAX forward with pair_batch=True
    and against the port's own pair_batch=False, stage by stage, and two_view_forward
    likewise.

Tolerances are those of tests/test_torch_layers.py (single layer 1e-5, stacked modules
1e-4 of the output scale) and tests/test_torch_forward_mv3.py (volumes rtol 1e-4 atol
5e-4, depths rtol 1e-5 atol 2e-5): fp32 on both sides, other summation orders. Batched
against sequential inside the port uses the same bounds; on the CPU the two come out
equal or within a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.data.synthetic import synthetic_batch, synthetic_scene
from atvsnet_tpu.models.atvsnet import multi_view_forward as jax_forward
from atvsnet_tpu.models.tvsnet import init_params
from atvsnet_tpu.models.tvsnet import two_view_forward as jax_two_view
from atvsnet_tpu.nn import crm as jcrm
from atvsnet_tpu.nn import layers as JL
from atvsnet_tpu.nn import refine as jrefine
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models import tvsnet as port_tvsnet
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import two_view_forward
from atvsnet_torch.nn import layers as TL
from atvsnet_torch.nn.crm import CRM
from atvsnet_torch.nn.refine import RefineNet
from atvsnet_torch.params import load_jax_params, load_model

torch.set_num_threads(2)

STAGES = {"prob_volumes": "volume", "prob_volume_agg": "volume",
          "refined_prob_volumes": "volume", "depth_views": "depth",
          "depth_agg_initial": "depth", "depth": "depth", "depth_up": "depth"}
TOL = {"volume": dict(rtol=1e-4, atol=5e-4), "depth": dict(rtol=1e-5, atol=2e-5)}
CASES = {
    "mv3_32_b2_compat": (dict(view_num=3, max_d=8, max_h=32, max_w=32, reference_compat=True), 2),
    "mv4_32x64": (dict(view_num=4, max_d=8, max_h=32, max_w=64), 1),
}


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(np.array(a))


def close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol, atol=tol * max(1.0, np.abs(ref).max()))


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def load(module, tree):
    return load_jax_params(module, jax.tree_util.tree_map(np.asarray, tree)).eval().requires_grad_(False)


@pytest.mark.parametrize("shape", [(6, 4, 5, 3), (4, 3, 4, 5, 2)])
def test_batch_stat_norm_stacked_equals_per_element(shape):
    x = rand(*shape) * 2 + 0.5
    beta = rand(shape[-1], seed=1)
    stacked = TL.batch_stat_norm(t(x), 1e-3, t(beta))
    for i in range(shape[0]):
        np.testing.assert_array_equal(stacked[i:i + 1].numpy(),
                                      TL.batch_stat_norm(t(x[i:i + 1]), 1e-3, t(beta)).numpy())
    close(stacked, JL.batch_stat_norm(j(x), 1e-3, j(beta), groups=2), 1e-5)


def test_crm_stacked_batch():
    p = jcrm.init_crm(jax.random.PRNGKey(2), 8, 4)
    m = load(CRM(8, 4), p)
    warped, ref2d = rand(2, 8, 8, 8, 4), rand(2, 8, 8, 4, seed=7)
    got = m((t(warped), t(ref2d)))
    ref = jax.jit(lambda p, a, b: jcrm.crm(p, (a, b), bn_groups=2))(p, j(warped), j(ref2d))
    for g, r in zip(got, ref):
        close(g, r, 1e-4)
    for i in range(2):
        one = m((t(warped[i:i + 1]), t(ref2d[i:i + 1])))
        for g, o in zip(got, one):
            close(g[i:i + 1], o, 1e-5)


def test_refine_net_stacked_batch():
    F, f = 4, 4
    p = jrefine.init_refine_net(jax.random.PRNGKey(4), 3 * F, (F + 1) + 2, f)
    m = load(RefineNet(3 * F, (F + 1) + 2, f), p)
    B, D, h, w = 2, 8, 8, 8
    arrs = [rand(B, D, h, w, F, seed=9), rand(B, h, w, 2 * F, seed=10),
            rand(B, D, h, w, 2, seed=11), rand(B, h, w, 2, seed=12),
            rand(B, D, h, w, 1, seed=13), rand(B, D, h, w, 1, seed=14)]

    def port(a):
        return m((t(a[0]), t(a[1])), (t(a[2]), t(a[3]), F), t(a[4]), t(a[5]))

    got = port(arrs)
    ref = jax.jit(lambda p, a, b, c, d, e, g: jrefine.refine_net(p, (a, b), (c, d, F), e, g, bn_groups=2))(
        p, *map(j, arrs))
    for g, r in zip(got, ref):
        close(g, r, 1e-4)
    for i in range(B):
        one = port([a[i:i + 1] for a in arrs])
        for g, o in zip(got, one):
            close(g[i:i + 1], o, 1e-5)


@pytest.fixture(scope="module")
def outputs():
    cache = {}

    def run(case):
        if case not in cache:
            kw, B = CASES[case]
            jcfg = JaxConfig(pair_batch=True, **kw)
            params = init_params(jax.random.PRNGKey(0), jcfg)
            images, cams = synthetic_batch(view_num=kw["view_num"], B=B, H=kw["max_h"],
                                           W=kw["max_w"], D=kw["max_d"], seed=7)
            ref = jax.jit(lambda p, i, c: jax_forward(p, i, c, jcfg, out_prob_map=True))(
                params, jnp.asarray(images), jnp.asarray(cams))
            cfg = PipelineConfig(pair_batch=True, **kw)
            model = load_model(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
            batched = multi_view_forward(model, images, cams, cfg, out_prob_map=True)
            sequential = multi_view_forward(model, images, cams, cfg.replace(pair_batch=False),
                                            out_prob_map=True)
            cache[case] = tuple({k: np.asarray(v) for k, v in o.items()}
                                for o in (ref, batched, sequential))
        return cache[case]

    return run


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("case", list(CASES))
def test_pair_batch_stage_matches_jax_and_sequential(outputs, case, stage):
    ref, batched, sequential = outputs(case)
    assert set(batched) == set(ref) == set(sequential)
    assert batched[stage].shape == ref[stage].shape == sequential[stage].shape
    assert np.isfinite(batched[stage]).all()
    np.testing.assert_allclose(batched[stage], ref[stage], **TOL[STAGES[stage]])
    np.testing.assert_allclose(batched[stage], sequential[stage], **TOL[STAGES[stage]])


def test_pair_batch_stacks_the_sweeps(monkeypatch):
    """The batched path really batches: the CRM sees 2B sweeps per pair, the refine net
    P * B pairs at once; the sequential path sees B each time."""
    kw = dict(view_num=4, max_d=8, max_h=32, max_w=32)
    cfg = PipelineConfig(**kw)
    model = port_tvsnet.init_model(cfg, seed=0, device="cpu")
    images, cams = synthetic_batch(view_num=4, B=2, H=32, W=32, D=8, seed=3)
    seen = {"crm": [], "refine": []}
    model.crm.register_forward_pre_hook(lambda m, args: seen["crm"].append(args[0][0].shape[0]))
    model.refine.register_forward_pre_hook(lambda m, args: seen["refine"].append(args[0][0].shape[0]))
    multi_view_forward(model, images, cams, cfg)
    assert seen == {"crm": [2] * 6, "refine": [2] * 3}
    seen["crm"].clear(), seen["refine"].clear()
    multi_view_forward(model, images, cams, cfg.replace(pair_batch=True))
    assert seen == {"crm": [4] * 3, "refine": [6]}


def test_two_view_pair_batch():
    kw = dict(view_num=2, max_d=8, max_h=32, max_w=32)
    jcfg = JaxConfig(pair_batch=True, **kw)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    images, cams = synthetic_scene(view_num=2, H=32, W=32, D=8, seed=7)
    ref = jax.jit(lambda p, i, c: jax_two_view(p, i, c, jcfg))(params, jnp.asarray(images), jnp.asarray(cams))
    cfg = PipelineConfig(pair_batch=True, **kw)
    model = load_model(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    batched = two_view_forward(model, images, cams, cfg)
    sequential = two_view_forward(model, images, cams, cfg.replace(pair_batch=False))
    for key, kind in (("refined_prob_vol", "volume"), ("depth", "depth"), ("depth_up", "depth"),
                      ("depth_initial", "depth")):
        np.testing.assert_allclose(batched[key].numpy(), np.asarray(ref[key]), **TOL[kind], err_msg=key)
        np.testing.assert_allclose(batched[key].numpy(), sequential[key].numpy(), **TOL[kind], err_msg=key)
