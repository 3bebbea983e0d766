"""Storage quantization in the port (PipelineConfig.act_quant, act_quant_range, warp_quant)
against the JAX package's (atvsnet_tpu/numerics.py policy), on the CPU.

  * the link quantization (nn.layers.quantize_act, JAX's _maybe_quant_act) and the warp
    quantization (geometry.warp.quantize_warp, JAX's _maybe_quant_warp) on the same
    seeded tensors: equal to the bit (both round half to even and divide in fp32); 4D
    tensors and nearest sweeps pass untouched;
  * through plane_sweep_warp, whose bilinear samples differ between the packages in the
    last bits: the quantized volumes agree within one lattice step, at no more than 0.1%
    of the elements (measured: none);
  * PipelineConfig validation as JAX's, act_quant="int8mxu" among the modes it takes
    (tests/test_torch_int8_conv.py holds that mode's convs against JAX's);
  * stage 1 (tvsnet_base) and stage 3 (tvsnet_refine) of one pair at act_quant int8s and
    int8, the port's and JAX's fed the same inputs, the port's seeded weights carried over
    to JAX by export_jax_params: every link quantized in the same place, held at the
    unquantized stage tolerances of tests/test_torch_forward_mv3.py (volumes rtol 1e-4,
    atol 5e-4; depths rtol 1e-5, atol 2e-5); measured at most 2.9e-6 on the volumes.
    With warp_quant on, the two packages' bilinear samples differ in the last bit and a
    sample within that of a lattice tie lands one step apart, which the CRM's links
    amplify (the port's own stage 1 moves as far when its features change by 1e-6 of
    their value), so the warp lattice is held by the tests above;
  * the small forward (5 views, 32x32, D=8, the same weights) at int8s + int8 against
    JAX's forward at that config. A value within float noise of a lattice tie lands one
    step apart in the two packages, and the U-Nets' later links and refinement amplify
    such steps: the port's own quantized forward moves by a mean of 1.1e-3 and at most
    4.2e-3 sweep units when its input images change by 1e-6 of their value (unquantized:
    4e-7 and 1e-6). Measured against JAX: depth mean 7.0e-4, max 2.7e-3; depth_views
    mean 4.9e-4, max 3.5e-3; depth_agg_initial mean 2.8e-4, max 1.1e-3. Bounds: mean
    2e-3, max 1e-2 sweep units on each, about 3x the measured gap;
  * the SPMD forward equals the sequential one under quantization (JAX
    tests/test_parallel.py:53), at that test's rtol 5e-4, atol 5e-5;
  * a quantized serving bucket is distinct and moves the depth (JAX
    tests/test_serving.py:189);
  * the eval CLI's --act-quant / --warp-quant on a fabricated scene.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu import numerics
from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.geometry import warp as jw
from atvsnet_tpu.models import tvsnet as jt
from atvsnet_tpu.models.atvsnet import multi_view_forward as jax_forward
from atvsnet_tpu.nn import layers as jl
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.pfm import load_pfm
from atvsnet_torch.data.synthetic import make_cam, synthetic_scene, write_eth3d_scene
from atvsnet_torch.geometry import warp as tw
from atvsnet_torch.geometry.homography import get_homographies
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.models.tvsnet import extract_features, tvsnet_base, tvsnet_refine
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import int8_conv as I
from atvsnet_torch.params import export_jax_params, init_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd
from atvsnet_torch.serving import DepthEstimator

from tests.test_torch_serving import _scene_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(view_num=5, max_d=8, max_h=32, max_w=32)
QUANT = dict(act_quant="int8s", warp_quant="int8")
FORWARD_KEYS = ("depth", "depth_agg_initial", "depth_views")
FORWARD_MEAN, FORWARD_MAX = 2e-3, 1e-2
VOLUME_TOL, DEPTH_TOL = dict(rtol=1e-4, atol=5e-4), dict(rtol=1e-5, atol=2e-5)


def _volume(shape, seed, relu=False):
    y = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2.5
    if relu:
        y = np.maximum(y, 0.0)
    y.flat[::97] = 0.5 * 6.0 / 127.0      # exact ties of the int8s lattice at range 6
    return y


@pytest.mark.parametrize("mode,rng,relu", [("int8", 6.0, False), ("int8", 6.0, True),
                                           ("int8s", 6.0, True), ("int8s", 6.0, False),
                                           ("int8s", 4.0, True), ("int8s", 4.0, False),
                                           ("none", 6.0, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_link_quantization_matches_jax_to_the_bit(mode, rng, relu, dtype):
    for shape in ((2, 8, 6, 5, 3), (2, 6, 5, 3)):          # a volume link, then a 2D one
        y = _volume(shape, seed=len(shape), relu=relu)
        yj = jnp.asarray(y).astype(dtype)
        with numerics.scope(numerics.NumericsPolicy(act_quant=mode, act_quant_range=rng)):
            want = np.asarray(jl._maybe_quant_act(yj, nonneg=relu).astype(jnp.float32))
        quant = L.ActQuant.of(PipelineConfig(act_quant=mode, act_quant_range=rng))
        got = L.quantize_act(torch.from_numpy(np.array(yj.astype(jnp.float32))).to(
            getattr(torch, dtype)), quant, nonneg=relu)
        np.testing.assert_array_equal(got.float().numpy(), want)
        if len(shape) == 4 or mode == "none":
            np.testing.assert_array_equal(want, np.asarray(yj.astype(jnp.float32)))


def _rig(B=2, H=12, W=16, D=5):
    K = np.array([[8.0, 0.0, 8.0], [0.0, 8.0, 6.0], [0.0, 0.0, 1.0]])
    a = 0.05
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
    left, right = make_cam(K, np.eye(3), np.zeros(3)), make_cam(K, R, np.array([-0.13, 0.02, 0.01]))
    cl, cr = torch.from_numpy(np.stack([left] * B)), torch.from_numpy(np.stack([right] * B))
    return get_homographies(cl, cr, D, torch.full((B,), 0.2), torch.full((B,), 0.02))


def test_warp_quantization_matches_jax_to_the_bit():
    rng = np.random.RandomState(7)
    img = (rng.rand(2, 12, 16, 4).astype(np.float32) - 0.3) * 5.0
    out = tw.plane_sweep_warp(torch.from_numpy(img), _rig()).numpy()
    with numerics.scope(numerics.NumericsPolicy(warp_quant="int8")):
        # the JAX volume is (B, H, W, D, C) there; the scale broadcasts the same way
        want = np.asarray(jw._maybe_quant_warp(jnp.asarray(out), jnp.asarray(img)))
    got = tw.quantize_warp(torch.from_numpy(out), torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[out == 0] == 0).all()


def test_plane_sweep_warp_quantized_as_jax():
    rng = np.random.RandomState(7)
    img = (rng.rand(2, 12, 16, 4).astype(np.float32) - 0.3) * 5.0
    H = _rig()
    with numerics.scope(numerics.NumericsPolicy(warp_quant="int8")):
        want = np.asarray(jw.plane_sweep_warp(jnp.asarray(img), jnp.asarray(H.numpy())))
        want_n = np.asarray(jw.plane_sweep_warp(jnp.asarray(img), jnp.asarray(H.numpy()),
                                                method="nearest"))
    got = tw.plane_sweep_warp(torch.from_numpy(img), H, quant="int8").numpy()
    step = (np.abs(img).max(axis=(1, 2)) / 127.0 + 1e-12)[:, None, None, None]
    off = np.abs(got - want) / step
    assert off.max() <= 1.0 + 1e-4 and np.mean(off > 0.5) <= 1e-3
    # every element lies on the lattice, and nearest sweeps never quantize
    np.testing.assert_allclose(got / step, np.round(got / step), atol=1e-3)
    base_n = tw.plane_sweep_warp(torch.from_numpy(img), H, method="nearest", quant="int8")
    np.testing.assert_array_equal(base_n.numpy(), want_n)
    assert not np.array_equal(got, tw.plane_sweep_warp(torch.from_numpy(img), H).numpy())


@pytest.mark.parametrize("kw", [dict(act_quant="int4"), dict(warp_quant="int4"),
                                dict(warp_quant="int8s"), dict(act_quant="int8"),
                                dict(act_quant="int8s", act_quant_range=4.0),
                                dict(warp_quant="int8"), dict(act_quant="int8mxu")])
def test_config_validates_as_jax(kw):
    try:
        JaxConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PipelineConfig(**kw)
        assert str(got.value) == str(e)
    else:
        cfg = PipelineConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())


def test_int8mxu_is_refused_with_a_reason():
    """act_quant="int8mxu" validates as JAX's config does: accepted, with JAX's list of
    modes in the message of every mode refused; what is refused with a reason now is a
    tensor that its int8 conv kernel cannot take (a CPU tensor, here)."""
    assert JaxConfig(act_quant="int8mxu").act_quant == "int8mxu"
    assert PipelineConfig(act_quant="int8mxu").act_quant == "int8mxu"
    assert L.ActQuant.of(PipelineConfig(act_quant="int8mxu")) == L.ActQuant("int8mxu", 6.0)
    for bad in ("int4", "int8mxu2"):
        with pytest.raises(ValueError) as e:
            PipelineConfig(act_quant=bad)
        assert str(e.value) == f"act_quant={bad!r}: expected one of none|int8|int8s|int8mxu"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        I.conv3d_int8_cuda(torch.zeros((1, 2, 2, 2, 8), dtype=torch.int8),
                           torch.zeros((8, 8, 3, 3, 3), dtype=torch.int8), 1, [(1, 1)] * 3)
    assert PipelineConfig().act_quant == "none" and PipelineConfig().act_quant_range == 6.0
    assert PipelineConfig().warp_quant == "none"


_cache = {}


def _forwards():
    """(JAX outputs, the port's) of the quantized small forward; one jit per module."""
    if "fwd" not in _cache:
        images, cams = synthetic_scene(view_num=5, H=32, W=32, D=8, seed=3)
        cfg = PipelineConfig(**SIZE, **QUANT)
        model = init_model(cfg, seed=0, device="cpu")
        jcfg = JaxConfig(**SIZE, **QUANT)
        ref = jax.jit(lambda p, i, c: jax_forward(p, i, c, jcfg))(
            _unflatten(export_jax_params(model)), jnp.asarray(images), jnp.asarray(cams))
        got = multi_view_forward(model, images, cams, cfg)
        plain = multi_view_forward(model, images, cams, cfg.replace(act_quant="none",
                                                                    warp_quant="none"))
        _cache["fwd"] = ({k: np.asarray(v) for k, v in ref.items()},
                         {k: v.numpy() for k, v in got.items()},
                         {k: v.numpy() for k, v in plain.items()})
    return _cache["fwd"]


@pytest.mark.parametrize("key", FORWARD_KEYS)
def test_quantized_forward_matches_jax(key):
    ref, got, plain = _forwards()
    assert got[key].shape == ref[key].shape and np.isfinite(got[key]).all()
    diff = np.abs(got[key] - ref[key])
    assert diff.mean() <= FORWARD_MEAN and diff.max() <= FORWARD_MAX, (diff.mean(), diff.max())
    assert np.abs(plain[key] - got[key]).max() > 0


def _stage_inputs():
    """The port's features and first-stage outputs of the small scene, as numpy: the
    common inputs of both packages' stages."""
    if "stage" not in _cache:
        images, cams = synthetic_scene(view_num=5, H=32, W=32, D=8, seed=3)
        cfg = PipelineConfig(**SIZE)
        model = init_model(cfg, seed=0, device="cpu")
        with torch.no_grad():
            x, c = torch.from_numpy(images), torch.from_numpy(cams)
            feats = extract_features(model, x, cfg)
            shallow = extract_features(model, x, cfg, shallow=True)
            base = tvsnet_base(model, feats[:, 0], feats[:, 1], c[:, 0], c[:, 1], cfg,
                               c[:, 0, 1, 3, 0], c[:, 0, 1, 3, 1])
        _cache["stage"] = (model, cams, feats.numpy(), shallow.numpy(),
                           {k: getattr(base, k).numpy() for k in base._fields})
    return _cache["stage"]


@pytest.mark.parametrize("mode", ["int8s", "int8"])
def test_quantized_stages_match_jax_on_the_same_inputs(mode):
    model, cams, feats, shallow, base = _stage_inputs()
    tree = _unflatten(export_jax_params(model))
    cfg, jcfg = PipelineConfig(**SIZE, act_quant=mode), JaxConfig(**SIZE, act_quant=mode)
    ds, di = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    with numerics.scope(jcfg.numerics()):
        jb = jax.jit(lambda p: jt.tvsnet_base(p, feats[:, 0], feats[:, 1], cams[:, 0], cams[:, 1],
                                              jcfg, ds, di))(tree)
        jr = jax.jit(lambda p: jt.tvsnet_refine(
            p, base["depth"], base["depth_view"], base["prob_volume"], base["filtered_cost"],
            cams[:, 0], cams[:, 1], shallow[:, 0], shallow[:, 1], jcfg, ds, di))(tree)
    f, c, sh = torch.from_numpy(feats), torch.from_numpy(cams), torch.from_numpy(shallow)
    with torch.no_grad():
        tb = tvsnet_base(model, f[:, 0], f[:, 1], c[:, 0], c[:, 1], cfg, c[:, 0, 1, 3, 0],
                         c[:, 0, 1, 3, 1])
        tr = tvsnet_refine(model, *(torch.from_numpy(base[k]) for k in
                                    ("depth", "depth_view", "prob_volume", "filtered_cost")),
                           c[:, 0], c[:, 1], sh[:, 0], sh[:, 1], cfg, c[:, 0, 1, 3, 0],
                           c[:, 0, 1, 3, 1])
    for got, want in ((tb.prob_volume, jb.prob_volume), (tb.filtered_cost, jb.filtered_cost),
                      (tr[0], jr[0]), (tr[1], jr[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VOLUME_TOL)
    for got, want in ((tb.depth, jb.depth), (tb.depth_view, jb.depth_view)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEPTH_TOL)
    # the quantization is on: the unquantized stage is elsewhere
    with torch.no_grad():
        plain = tvsnet_base(model, f[:, 0], f[:, 1], c[:, 0], c[:, 1], PipelineConfig(**SIZE),
                            c[:, 0, 1, 3, 0], c[:, 0, 1, 3, 1])
    assert np.abs(plain.prob_volume.numpy() - np.asarray(jb.prob_volume)).max() > 1e-2


@pytest.mark.parametrize("kw", [dict(act_quant="int8"), QUANT])
def test_spmd_forward_equals_sequential_under_quantization(kw):
    images, cams = synthetic_scene(view_num=5, H=32, W=32, D=8, seed=4)
    cfg = PipelineConfig(**SIZE, **kw)
    model = init_model(cfg, seed=1, device="cpu")
    seq = multi_view_forward(model, images, cams, cfg)
    with torch.no_grad():
        spmd = multi_view_forward_spmd(model, images, cams, cfg)
    for k in ("depth", "depth_views", "depth_up"):
        np.testing.assert_allclose(spmd[k].numpy(), seq[k].numpy(), rtol=5e-4, atol=5e-5)
    assert np.isfinite(spmd["depth_up"].numpy()).all()


def test_quantized_bucket_is_distinct_and_moves_the_depth():
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    est = DepthEstimator(cfg, device="cpu")
    c2 = est.add_bucket(**QUANT)
    assert c2.act_quant == "int8s" and c2.warp_quant == "int8" and len(est.buckets) == 2
    assert est.add_bucket(**QUANT) == c2 and len(est.buckets) == 2
    images, cams = _scene_arrays(3, 32, 32, cfg.max_d, seed=5)
    base = est.predict(images, cams)
    quant = DepthEstimator(cfg.replace(**QUANT), device="cpu").predict(images, cams)
    assert np.isfinite(quant["depth"]).all()
    assert np.abs(base["depth"] - quant["depth"]).max() > 0


@pytest.fixture(scope="module")
def eval_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_eval")
    write_eth3d_scene(str(root / "eth3d" / "s0"), 3, 64, 96, 0, num_d=16, num_spheres=2)
    return root


def test_eval_cli_quant_flags(eval_scene, capsys):
    kw = dict(view_num=3, max_d=16, max_h=64, max_w=96, device="cpu", load_workers=1,
              write_workers=1)
    run_eval_pc(str(eval_scene), str(eval_scene / "plain"), ["s0"], **kw)
    run_eval_pc(str(eval_scene), str(eval_scene / "quant"), ["s0"], act_quant="int8s",
                warp_quant="int8", **kw)
    log = capsys.readouterr()
    assert "act_quant=int8s warp_quant=int8" in log.out + log.err
    folders = [eval_scene / k / "s0" / "depths_atvsnet" for k in ("plain", "quant")]
    assert sorted(os.listdir(folders[0])) == sorted(os.listdir(folders[1]))
    maps = [load_pfm(str(f / "00000000.pfm")) for f in folders]
    assert np.isfinite(maps[1]).all() and np.abs(maps[0] - maps[1]).max() > 0


@pytest.mark.parametrize("argv,message", [
    (["--act-quant", "int4"], "act_quant='int4': expected one of none|int8|int8s|int8mxu"),
    (["--warp-quant", "int8s"], "warp_quant='int8s': expected one of none|int8")])
def test_eval_cli_refuses_what_the_config_refuses(argv, message):
    proc = subprocess.run([sys.executable, "-m", "atvsnet_torch.cli.eval_pointcloud",
                           "--device", "cpu"] + argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and message in proc.stderr, proc.stderr[-2000:]
