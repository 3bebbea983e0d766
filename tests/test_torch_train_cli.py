"""The port's train CLI and train-state checkpoints (CPU), and a train state carried over
from the JAX package.

* cli.train.main with --device cpu at 3 views, 32x32, D=8 on rendered scenes: finite
  logged losses, --resume continues the step count (and the optimizer's), and the
  exported params load with params.load_model and with the JAX package's load_params.
* save_train_state / load_train_state round-trip the state exactly.
* load_jax_train_state reads what atvsnet_tpu.utils.ckpt.save_train_state wrote after two
  JAX train steps (cosine schedule with warmup, weight decay, clipping): params, Adam
  moments and counts equal to the JAX state's, bit for bit. Then one more step in each
  package on the same batch. Bounds: the loss at rtol 1e-5; the step's parameter update
  (new - old) within 2e-2 of its own norm globally, and every parameter within 2 lr of
  JAX's. Adam divides each gradient element by its running RMS, so an element whose
  gradient so far is rounding noise steps by up to lr, in either direction, in either
  package. Measured: loss 1.1e-6, update 1.3e-3, largest parameter difference 9.5e-4 =
  0.95 lr (one element of fem/conv3_x_0/conv2/w; the next largest 1.1e-4).
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
from atvsnet_tpu.models.train import TrainState as JaxTrainState
from atvsnet_tpu.models.train import make_optimizer as jax_make_optimizer
from atvsnet_tpu.models.train import train_step as jax_train_step
from atvsnet_tpu.utils.ckpt import load_params as jax_load_params
from atvsnet_tpu.utils.ckpt import save_train_state as jax_save_train_state
from atvsnet_torch.cli import train as cli
from atvsnet_torch.config import PipelineConfig, TrainConfig
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.train import init_train_state, make_optimizer, train_step
from atvsnet_torch.nn.layers import torch_to_tf
from atvsnet_torch.params import flatten, load_model
from atvsnet_torch.utils import ckpt

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=8, max_h=32, max_w=32)


@pytest.fixture(autouse=True, scope="module")
def _onednn_off():
    """oneDNN off for this file's tests only: see tests/test_torch_train.py."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_cli_trains_resumes_and_exports(tmp_path):
    state_path, export = str(tmp_path / "run" / "state.npz"), str(tmp_path / "params.npz")
    args = ["--synthetic_planes", "--num_spheres", "1", "--max_h", "32", "--max_w", "32",
            "--max_d", "8", "--log_every", "2", "--ckpt", state_path, "--device", "cpu"]
    first = cli.main(args + ["--steps", "4", "--export_params", export])
    assert (first["start_step"], first["step"]) == (0, 4)
    assert [s for s, _ in first["losses"]] == [2, 4]
    assert all(np.isfinite(loss) for _, loss in first["losses"])
    assert first["first_step_s"] > 0 and first["peak_memory_bytes"] is None
    with np.load(state_path) as z:
        assert int(z["step"]) == int(z["count"]) == 4

    resumed = cli.main(args + ["--steps", "6", "--resume", "--lr_schedule", "cosine"])
    assert (resumed["start_step"], resumed["step"]) == (4, 6)
    assert [s for s, _ in resumed["losses"]] == [6]
    with np.load(state_path) as z:
        assert int(z["step"]) == int(z["count"]) == 6

    cfg = PipelineConfig(**SIZE)
    model = load_model(export, cfg, device="cpu")
    tree = flatten(jax.tree_util.tree_map(np.asarray, jax_load_params(export)))
    own = dict(model.named_parameters())
    assert tree.keys() == {n.replace(".", "/") for n in own}
    scene = render_multiplane_scene(view_num=3, H=32, W=32, D=8, seed=9, num_spheres=1)
    out = multi_view_forward(model, scene["images"], scene["cams"], cfg)
    assert bool(torch.isfinite(out["depth"]).all()) and out["depth"].shape == (1, 8, 8, 1)


def _batch(seed):
    s = render_multiplane_scene(view_num=3, H=32, W=32, D=8, seed=seed, num_spheres=2)
    return {k: s[k] for k in ("images", "cams", "depth_gt")}


def _port_state(tcfg):
    model = load_model(SPHERES, PipelineConfig(**SIZE), device="cpu")
    opt = make_optimizer(tcfg)
    return init_train_state(model, opt), opt


def test_port_train_state_roundtrip(tmp_path):
    tcfg = TrainConfig()
    state, opt = _port_state(tcfg)
    state, _ = train_step(state, _batch(1), PipelineConfig(**SIZE), tcfg, opt)
    ckpt.save_train_state(str(tmp_path / "s"), state)            # ".npz" is appended
    back, _ = _port_state(tcfg)
    back = ckpt.load_train_state(str(tmp_path / "s.npz"), back)
    assert (back.step, back.opt_state.count) == (1, 1)
    for n, p in back.model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[n]), n
        assert torch.equal(back.opt_state.mu[n], state.opt_state.mu[n])
        assert torch.equal(back.opt_state.nu[n], state.opt_state.nu[n])


def _tf(t):
    t = t.detach()
    return (torch_to_tf(t) if t.ndim > 2 else t).numpy()


def test_state_from_the_jax_package_takes_the_same_next_step(tmp_path):
    kw = dict(learning_rate=1e-3, weight_decay=1e-4, lr_schedule="cosine", warmup_steps=1,
              decay_steps=10)
    jcfg, jtcfg = JaxConfig(**SIZE), JaxTrainConfig(**kw)
    tx = jax_make_optimizer(jtcfg)
    params = jax_load_params(SPHERES)
    jstate = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(lambda s, b: jax_train_step(s, b, jcfg, jtcfg, tx))
    for seed in (1, 2):
        jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in _batch(seed).items()})
    path = str(tmp_path / "jax_state.npz")
    jax_save_train_state(path, jstate)
    before = flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    adam = jstate.opt_state[-1][0]
    mu = flatten(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = flatten(jax.tree_util.tree_map(np.asarray, adam.nu))
    jnext, jmetrics = step(jstate, {k: jnp.asarray(v) for k, v in _batch(3).items()})
    after = flatten(jax.tree_util.tree_map(np.asarray, jnext.params))

    tcfg = TrainConfig(**kw)
    state, opt = _port_state(tcfg)
    state = ckpt.load_jax_train_state(path, state)
    assert (state.step, state.opt_state.count) == (2, 2)
    for n, p in state.model.named_parameters():
        k = n.replace(".", "/")
        np.testing.assert_array_equal(_tf(p), before[k], err_msg=k)
        np.testing.assert_array_equal(_tf(state.opt_state.mu[n]), mu[k], err_msg=k)
        np.testing.assert_array_equal(_tf(state.opt_state.nu[n]), nu[k], err_msg=k)

    state, metrics = train_step(state, _batch(3), PipelineConfig(**SIZE), tcfg, opt)
    assert state.step == 3
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    ours = {n.replace(".", "/"): _tf(p) for n, p in state.model.named_parameters()}
    num = sum(float(np.square((ours[k] - before[k]) - (after[k] - before[k])).sum()) for k in after)
    den = sum(float(np.square(after[k] - before[k]).sum()) for k in after)
    assert (num / den) ** 0.5 < 2e-2
    assert max(float(np.abs(ours[k] - after[k]).max()) for k in after) <= 2 * kw["learning_rate"]


def test_a_constant_rate_state_and_a_wrong_file(tmp_path):
    """Without a schedule the chain has no ScaleByScheduleState: the count comes from Adam's
    state alone. A params-only file is no train state."""
    params = jax_load_params(SPHERES)
    tx = jax_make_optimizer(JaxTrainConfig())
    path = str(tmp_path / "fresh.npz")
    jax_save_train_state(path, JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32)))
    state, _ = _port_state(TrainConfig())
    state = ckpt.load_jax_train_state(path, state)
    assert (state.step, state.opt_state.count) == (0, 0)
    assert all(not bool(m.any()) for m in state.opt_state.mu.values())
    with pytest.raises(KeyError):
        ckpt.load_jax_train_state(SPHERES, state)
