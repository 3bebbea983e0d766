"""The JAX package's public helpers that no path calls, against their ports, on the CPU.

Each helper gets the same numpy-seeded inputs (and, where it has weights, the same
weights) in both packages. Tolerances, with the value measured when each was set
(torch 2.13 CPU):
  * camera_center, depth_range_from_cams: rtol 1e-6 (measured 3.7e-9 absolute, and 0);
  * the layer helpers (l2_pool_same, dense, l2_normalize, split_separable_conv2d):
    rtol 1e-5, atol 1e-5 (measured at most 1.4e-6, split_separable_conv2d at rate 2,
    2.8e-7 of its largest value);
  * homography_warp, build_cost_volume, the view-trailing and 2D AAM forms,
    aam_aggregate and cost_volume_aggregation: atol 1e-5 (measured at most 1.2e-6,
    attention_activation; homography_warp 0); homography_warp's boolean mask equal,
    element for element (82% of the samples valid). The homographies are
    off-axis, so samples do not land on the pixel lattice, where rounding alone decides
    a border sample;
  * dropout by its statistics: JAX's PRNG stream cannot be drawn in torch;
  * StageTimer by the keys and counts of its summary for the same stages.
No JAX forward of the whole pipeline runs here.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atvsnet_tpu.geometry as jgeometry
from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.geometry import cameras as jc
from atvsnet_tpu.geometry import warp as jw
from atvsnet_tpu.models import tvsnet as jt
from atvsnet_tpu.nn import aam as jaam
from atvsnet_tpu.nn import layers as jl
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_tpu.utils import profiling as jprof
import atvsnet_torch.geometry as tgeometry
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.geometry import cameras as tc
from atvsnet_torch.geometry import warp as tw
from atvsnet_torch.geometry.homography import get_homographies
from atvsnet_torch.models import tvsnet as tt
from atvsnet_torch.nn import aam as taam
from atvsnet_torch.nn import layers as L
from atvsnet_torch.params import export_jax_params, init_model, load_jax_params
from atvsnet_torch.utils import profiling as tprof

torch.set_num_threads(2)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
VOLUME_ATOL = 1e-5


def _rng(seed):
    return np.random.RandomState(seed)


def _off_axis_homographies(B):
    """(B, 3, 3) homographies with a rotation, a shear and a perspective row, so no
    sample lands on the pixel lattice."""
    base = np.array([[0.97, 0.06, 0.83], [-0.04, 1.03, -0.61], [1.1e-3, -1.7e-3, 1.0]])
    jitter = 0.01 * _rng(4).randn(B, 3, 3) * np.array([[1, 1, 10], [1, 1, 10], [0.01, 0.01, 0]])
    return (base[None] + jitter).astype(np.float32)


# ---- the elementwise and layer helpers: one parametrised test ----


def _layer_case(name):
    """(JAX value, port value) of one helper on seeded inputs."""
    rng = _rng(0)
    x = rng.randn(2, 9, 10, 3).astype(np.float32)
    if name == "l2_pool_same":
        return jl.l2_pool_same(jnp.asarray(x), 3, 2), L.l2_pool_same(torch.from_numpy(x), 3, 2)
    if name.startswith("dense"):
        relu = name == "dense_relu"
        w, b = rng.randn(3, 5).astype(np.float32), rng.randn(5).astype(np.float32)
        return (jl.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu),
                L.dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), relu=relu))
    if name.startswith("l2_normalize"):
        if name == "l2_normalize_short":
            # vectors shorter than sqrt(eps): the clamp acts on the squared norm
            x = (x * 1e-8).astype(np.float32)
        return jl.l2_normalize(jnp.asarray(x), axis=-1), L.l2_normalize(torch.from_numpy(x), dim=-1)
    if name.startswith("split_separable_conv2d"):
        rate = int(name[-1])
        dw = rng.randn(3, 3, 3, 1).astype(np.float32)   # TF depthwise (kh, kw, C, 1)
        pw = rng.randn(1, 1, 3, 4).astype(np.float32)   # TF (1, 1, C, Cout)
        db, pb = rng.randn(3).astype(np.float32), rng.randn(4).astype(np.float32)
        ref = jl.split_separable_conv2d(jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw),
                                        jnp.asarray(db), jnp.asarray(pb), rate=rate)
        got = L.split_separable_conv2d(
            torch.from_numpy(x), L.tf_to_torch(torch.from_numpy(dw)),
            L.tf_to_torch(torch.from_numpy(pw)), torch.from_numpy(db), torch.from_numpy(pb),
            rate=rate)
        return ref, got
    raise KeyError(name)


LAYER_CASES = ["l2_pool_same", "dense_relu", "dense_linear", "l2_normalize",
               "l2_normalize_short", "split_separable_conv2d_rate1",
               "split_separable_conv2d_rate2"]


@pytest.mark.parametrize("name", LAYER_CASES)
def test_layer_helpers_match_jax(name):
    ref, got = _layer_case(name)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LAYER_TOL)


def test_l2_normalize_is_not_f_normalize():
    """The trap: torch.nn.functional.normalize clamps the norm, not its square."""
    x = torch.full((1, 4), 1e-8)
    assert not torch.allclose(L.l2_normalize(x), torch.nn.functional.normalize(x, dim=-1))


def test_dense_relu_splits_the_gradient_of_a_tie_as_jax():
    """dense's relu is activate's: a tie at 0 passes half the gradient, as jnp.maximum."""
    x, w, b = np.ones((2, 3), np.float32), np.zeros((3, 4), np.float32), np.zeros(4, np.float32)
    ref = jax.grad(lambda b_: jl.dense(jnp.asarray(x), jnp.asarray(w), b_).sum())(jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_(True)
    L.dense(torch.from_numpy(x), torch.from_numpy(w), bt).sum().backward()
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(bt.grad.numpy(), 1.0)


@pytest.mark.parametrize("name", ["camera_center", "depth_range_from_cams"])
def test_camera_helpers_match_jax(name):
    _, cams = synthetic_scene(view_num=3, H=32, W=48, D=8, seed=1)
    if name == "camera_center":
        ref, got = [jc.camera_center(jnp.asarray(cams))], [tc.camera_center(torch.from_numpy(cams))]
        assert got[0].shape == (1, 3, 3, 1)
    else:
        ref = jc.depth_range_from_cams(jnp.asarray(cams))
        got = tc.depth_range_from_cams(torch.from_numpy(cams))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


# ---- homography_warp ----


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_homography_warp_matches_jax(method):
    img = _rng(2).rand(2, 12, 16, 3).astype(np.float32)
    H = _off_axis_homographies(2)
    ref, ref_mask = jw.homography_warp(jnp.asarray(img), jnp.asarray(H), method=method,
                                       output_mask=True)
    got, mask = tw.homography_warp(torch.from_numpy(img), torch.from_numpy(H), method=method,
                                   output_mask=True)
    assert mask.dtype == torch.bool and tuple(mask.shape) == ref_mask.shape == (2, 12, 16, 1)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert 0 < mask.float().mean() < 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=VOLUME_ATOL)
    plain = tw.homography_warp(torch.from_numpy(img), torch.from_numpy(H), method=method)
    assert torch.equal(plain, got)


def test_homography_warp_identity_round_trip():
    """tests/test_geometry.py: the identity homography returns the interior unchanged; the
    right and bottom edges lie outside the valid window."""
    img = _rng(2).rand(1, 8, 8, 2).astype(np.float32)
    out, mask = tw.homography_warp(torch.from_numpy(img), torch.eye(3)[None], output_mask=True)
    np.testing.assert_allclose(out[0, :7, :7].numpy(), img[0, :7, :7], atol=1e-5)
    assert mask[0, :7, :7].all() and not mask[0, 7].any() and not mask[0, :, 7].any()


def test_plane_sweep_matches_per_plane_homography_warp():
    """tests/test_geometry.py: plane_sweep_warp's plane d is homography_warp by H[:, d]."""
    img = _rng(3).rand(1, 12, 16, 4).astype(np.float32)
    _, cams = synthetic_scene(view_num=2, H=48, W=64, D=5, seed=0)
    c = torch.from_numpy(cams)
    H = get_homographies(c[:, 0], c[:, 1], 5, torch.tensor([0.2]), torch.tensor([0.02]))
    vol = tw.plane_sweep_warp(torch.from_numpy(img), H)
    assert vol.shape == (1, 5, 12, 16, 4)
    for d in range(5):
        single = tw.homography_warp(torch.from_numpy(img), H[:, d])
        np.testing.assert_allclose(vol[:, d].numpy(), single.numpy(), atol=1e-6)


def test_geometry_exports_match_jax():
    def exported(pkg):
        return {n for n, v in vars(pkg).items()
                if not n.startswith("_") and callable(v) and not isinstance(v, type(pkg))}

    assert exported(tgeometry) == exported(jgeometry)
    assert tgeometry.homography_warp is tw.homography_warp


# ---- the cost volume and the view-trailing AAM ----

SMALL = dict(view_num=3, max_d=8, max_h=32, max_w=32)


@pytest.mark.parametrize("warp_ref", [False, True])
def test_build_cost_volume_matches_jax(warp_ref):
    rng = _rng(5)
    ref_f, view_f = (rng.rand(1, 8, 8, 4).astype(np.float32) for _ in range(2))
    _, cams = synthetic_scene(view_num=2, H=32, W=32, D=8, seed=0)
    ds, di = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    jvol, jh = jt.build_cost_volume(jnp.asarray(ref_f), jnp.asarray(view_f), cams[:, 0],
                                    cams[:, 1], JaxConfig(**SMALL), ds, di, warp_ref=warp_ref)
    c = torch.from_numpy(cams)
    vol, h = tt.build_cost_volume(torch.from_numpy(ref_f), torch.from_numpy(view_f), c[:, 0],
                                  c[:, 1], PipelineConfig(**SMALL), c[:, 0, 1, 3, 0],
                                  c[:, 0, 1, 3, 1], warp_ref=warp_ref)
    assert tuple(vol.shape) == jvol.shape == (1, 8, 8, 8, 8)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vol.numpy(), np.asarray(jvol), rtol=0, atol=VOLUME_ATOL)
    tiled = vol[..., :4] == torch.from_numpy(ref_f)[:, None]
    assert tiled.all() != warp_ref


def _attention(seed, channels=4):
    att = taam.Attention(channels, generator=torch.Generator().manual_seed(seed))
    return att, _unflatten(export_jax_params(att))


@pytest.mark.parametrize("form", ["attention_activation", "attention_aggregate"])
def test_view_trailing_attention_matches_jax(form):
    att, params = _attention(0)
    x = _rng(6).randn(2, 4, 6, 8, 4, 3).astype(np.float32)      # (B, D, h, w, C, N)
    ref = getattr(jaam, form)(params, jnp.asarray(x))
    got = getattr(taam, form)(att, torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=VOLUME_ATOL)


def test_view_trailing_aggregate_equals_the_stacked_one():
    att, _ = _attention(1)
    x = torch.from_numpy(_rng(7).randn(1, 4, 6, 8, 4, 3).astype(np.float32))
    with torch.no_grad():
        trailing = taam.attention_aggregate(att, x)
        stacked = taam.attention_aggregate_stacked(att, x.movedim(-1, 0).contiguous())
    np.testing.assert_allclose(trailing.numpy(), stacked.numpy(), rtol=1e-6, atol=1e-6)


def test_attention_2d_matches_jax():
    """A JAX init_attention_2d dict loads into Attention2D through params'
    load_jax_params; attention_activation_2d then matches JAX's."""
    params = jaam.init_attention_2d(jax.random.PRNGKey(0), "aam", 4)
    att = load_jax_params(taam.Attention2D(4), params)
    assert att.weight_unique.shape == (4, 4, 3, 3)
    x = _rng(8).randn(2, 10, 12, 4, 3).astype(np.float32)       # (B, H, W, C, N)
    ref = jaam.attention_activation_2d(params, jnp.asarray(x))
    got = taam.attention_activation_2d(att, torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=VOLUME_ATOL)
    seeded = [taam.Attention2D(4, generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(seeded[0].weight_shared, seeded[1].weight_shared)


_model_cache = {}


def _model():
    if "m" not in _model_cache:
        model = init_model(PipelineConfig(**SMALL), seed=0, device="cpu")
        _model_cache["m"] = (model, _unflatten(export_jax_params(model)))
    return _model_cache["m"]


@pytest.mark.parametrize("fn,stage,keepchannel", [("aam_aggregate", 1, None),
                                                  ("cost_volume_aggregation", 1, False),
                                                  ("cost_volume_aggregation", 2, True)])
def test_aam_aggregation_matches_jax(fn, stage, keepchannel):
    model, tree = _model()
    C = PipelineConfig().crm_base_filter
    vols = _rng(9).randn(1, 4, 6, 8, C, 2).astype(np.float32)   # (B, D, h, w, C, P)
    kw = {} if keepchannel is None else {"keepchannel": keepchannel}
    ref = getattr(jt, fn)(tree, jnp.asarray(vols), stage, **kw)
    got = getattr(tt, fn)(model, torch.from_numpy(vols), stage, **kw)
    assert tuple(got.shape) == ref.shape == ((1, 4, 6, 8) if keepchannel is False else vols.shape[:-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=VOLUME_ATOL)


# ---- dropout, by its statistics ----


def test_dropout_statistics_match_jax():
    x = np.ones((100, 100), np.float32)
    ref = np.asarray(jl.dropout(jnp.asarray(x), jax.random.PRNGKey(0), keep_prob=0.5))
    got = L.dropout(torch.from_numpy(x), 0.5, True, torch.Generator().manual_seed(0)).numpy()
    for out in (ref, got):
        assert set(np.unique(out)) <= {0.0, 2.0}
        assert abs(out.mean() - 1.0) < 0.05       # 5 standard deviations of the mean
    assert got.dtype == np.float32


def test_dropout_identity_and_seeded_mask():
    x = torch.from_numpy(_rng(10).rand(32, 32).astype(np.float32))
    assert L.dropout(x, 0.5, training=False) is x
    assert L.dropout(x, 1.0, training=True) is x
    first, second = (L.dropout(x, 0.7, True, torch.Generator().manual_seed(11)) for _ in range(2))
    assert torch.equal(first, second)
    kept = first != 0
    torch.testing.assert_close(first[kept], x[kept] / 0.7)
    assert not torch.equal(first, L.dropout(x, 0.7, True, torch.Generator().manual_seed(12)))


# ---- profiling ----


def test_stage_timer_summary_matches_jax(tmp_path):
    timers = [jprof.StageTimer(), tprof.StageTimer()]
    for t in timers:
        for name in ("load", "forward", "load", "write", "forward", "load"):
            with t.stage(name):
                pass
    ref, got = (t.summary() for t in timers)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].keys() == ref[k].keys()
        assert got[k]["count"] == ref[k]["count"]
        assert got[k]["total_s"] >= 0 and got[k]["mean_s"] == got[k]["total_s"] / got[k]["count"]
    timers[1].dump(str(tmp_path / "stages.json"))
    with open(tmp_path / "stages.json") as f:
        assert json.load(f) == got


def test_device_trace_writes_a_trace_only_with_a_logdir(tmp_path, monkeypatch):
    logdir = tmp_path / "trace"
    with tprof.device_trace(str(logdir)):
        torch.ones(8, 8).matmul(torch.ones(8, 8)).sum()
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was opened without a logdir")

    monkeypatch.setattr(tprof, "profile", refuse)
    for empty in (None, ""):
        with tprof.device_trace(empty):
            pass
    assert sorted(os.listdir(tmp_path)) == ["trace"]
