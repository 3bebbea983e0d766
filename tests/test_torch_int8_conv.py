"""act_quant="int8mxu" in the port against the JAX package's, on the CPU.

Under int8mxu the links are stored as under int8s, and each volume conv that the caller
marks qin=True runs on int8 operands: the input on the signed +-R lattice (si = R / 127),
the weights per tensor (sw = max|w| / 127 + 1e-12), int32 sums, the output rescaled by
si * sw (atvsnet_tpu/nn/layers.py:190-256). The port computes the sums with
ops.int8_conv.conv3d_int8: the CUDA kernel for CUDA tensors, the plain version (one
float64 conv3d, exact) here. JAX runs as its own tests run it, under
numerics.scope(NumericsPolicy(act_quant="int8mxu")) on the CPU.

  * quant_conv_operands is _quant_conv_operands to the bit (fp32 arithmetic, fp32 scalar
    divisors, round half to even), in fp32 and bf16;
  * the qin conv equals JAX's to the bit in fp32 and bf16, for every (Ci, Co) of the
    model, strides 1 and 2, odd and even sizes, relu on and off: the sums are exact
    integers in both, and the epilogue is one fp32 multiply and one cast;
  * the plain conv3d_int8 equals JAX's int32 convolution itself, with the pads of a
    depth split's block too; packed_weights is the kernel's layout;
  * conv_bn(qin=True) within 1e-5 of JAX's in fp32 (only the batch norm's fp32 reductions
    differ), and one lattice step where such a difference flips a rounding (measured:
    equal to the bit in fp32 and bf16); qin=False under int8mxu is int8s to the bit, as
    tests/test_nn.py:364-410 checks in JAX;
  * the CRM (stage 1), the refinement (stage 3) and the AAM stage by stage on the same
    inputs at tests/test_torch_quant.py's stage tolerances;
  * the whole forward on the trained weights (3 views, 64x96, D=32) in fp32 and bf16
    within the bounds that tests/test_torch_quant.py and tests/test_torch_quant_bf16.py
    give the other quantized modes (the chaos of lattice ties, not float noise). Measured
    (torch 2.13 CPU, sweep units, mean / max): fp32 depth 1.7e-4 / 1.1e-3, depth_agg_initial
    2.2e-4 / 1.2e-3, depth_views 3.0e-4 / 4.8e-3; bf16 3.2e-4 / 1.7e-3, 4.4e-4 / 2.5e-3,
    5.4e-4 / 6.4e-3. The port's own forward moves as far when its images change by 1e-6
    of their value (fp32 depth 1.3e-4 / 7.2e-4, depth_views 2.6e-4 / 6.2e-3; bf16 depth
    4.1e-4 / 2.2e-3, depth_views 8.3e-4 / 1.0e-2);
  * a served bucket under int8mxu, and the eval CLI with --act-quant int8mxu.
The depth split's int8 conv and forward are in tests/test_torch_int8_conv_depth.py.
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
from atvsnet_tpu.data.synthetic import render_multiplane_scene
from atvsnet_tpu.models import tvsnet as jt
from atvsnet_tpu.models.atvsnet import multi_view_forward as jax_forward
from atvsnet_tpu.nn import layers as jl
from atvsnet_tpu.utils.ckpt import _unflatten, load_params
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.pfm import load_pfm
from atvsnet_torch.data.synthetic import write_eth3d_scene
from atvsnet_torch.models import tvsnet as tt
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import int8_conv as I
from atvsnet_torch.params import export_jax_params, load_model
from atvsnet_torch.serving import DepthEstimator

from tests.test_torch_quant import DEPTH_TOL, VOLUME_TOL, _stage_inputs, SIZE
from tests.test_torch_serving import _scene_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
TRAINED = dict(view_num=3, max_d=32, max_h=64, max_w=96)
MXU = L.ActQuant("int8mxu")
KEYS = ("depth", "depth_agg_initial", "depth_views")
# the bounds of the other quantized modes against JAX (tests/test_torch_quant.py,
# tests/test_torch_quant_bf16.py), in sweep units
BOUNDS = {"float32": (2e-3, 1e-2), "bfloat16": (6e-3, 4.5e-2)}
CHANNELS = [(8, 8), (8, 16), (16, 32), (32, 64), (64, 64), (8, 1)]


def _mxu_scope(**kw):
    return numerics.scope(numerics.NumericsPolicy(act_quant="int8mxu", **kw))


def _as_torch(a, dtype):
    """A JAX array as a torch tensor of `dtype` with the same values."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(getattr(torch, dtype))


def _operands(shape, ci, co, seed):
    """A volume with values past +-R and exact ties of the signed lattice, and a TF-layout
    kernel (3, 3, 3, ci, co)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, ci) * 2.5).astype(np.float32)
    x.flat[::53] = 3.5 * 6.0 / 127.0          # a tie of the lattice: rounds to even, 4
    x.flat[1::53] = -2.5 * 6.0 / 127.0        # rounds to -2
    w = (rng.randn(3, 3, 3, ci, co) * 0.2).astype(np.float32)
    return x, w


@pytest.mark.parametrize("rng_", [6.0, 4.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_conv_operands_match_jax_to_the_bit(dtype, rng_):
    x, w = _operands((2, 5, 6, 7), 8, 16, seed=1)
    xj = jnp.asarray(x).astype(dtype)
    with _mxu_scope(act_quant_range=rng_):
        xq, wq, scale = jl._quant_conv_operands(xj, jnp.asarray(w))
    txq, twq, tscale = L.quant_conv_operands(_as_torch(xj, dtype), L.tf_to_torch(
        torch.from_numpy(w)), rng_)
    assert txq.dtype == twq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(L.torch_to_tf(twq).numpy(), np.asarray(wq))
    assert tscale.numpy().tobytes() == np.asarray(scale, np.float32).tobytes()
    assert np.abs(np.asarray(xq)).max() == 127 and np.abs(np.asarray(wq)).max() == 127


def _conv_case(i, ci, co, stride):
    """Odd and even sizes by case; D even at stride 2, as JAX's decomposition needs."""
    D = (6 if i % 2 else 4) if stride == 2 else (5 if i % 2 else 6)
    h, w = (7, 9) if i % 2 else (8, 6)
    return (1 + (i == 4), D, h, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ci,co", CHANNELS)
def test_qin_conv_matches_jax_to_the_bit(ci, co, stride, dtype):
    i = CHANNELS.index((ci, co))
    relu = i % 2 == 0
    x, w = _operands(_conv_case(i, ci, co, stride), ci, co, seed=10 + i)
    xj = jnp.asarray(x).astype(dtype)
    with _mxu_scope():
        want = jl.conv(xj, jnp.asarray(w), stride=stride, relu=relu, qin=True)
        float_conv = jl.conv(xj, jnp.asarray(w), stride=stride, relu=relu)
    got = L.conv(_as_torch(xj, dtype), L.tf_to_torch(torch.from_numpy(w)), stride=stride,
                 relu=relu, quant=MXU, qin=True)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the route is on: the float conv is elsewhere
    assert np.abs(np.asarray(float_conv.astype(jnp.float32)) - got.float().numpy()).max() > 0


@pytest.mark.parametrize("stride,H,W", [(1, 7, 9), (2, 8, 9), (2, 7, 10)])
def test_plain_int8_conv_is_jaxs_integer_convolution(stride, H, W):
    """conv3d_int8_torch's int32 sums against JAX's int8 convolution (the depth-tap
    decomposition with int32 accumulation) at TF-SAME pads, and the scaled epilogue."""
    rng = np.random.RandomState(stride + H)
    pads = [L._same_pads(n, 3, stride) for n in (6, H, W)]
    xq = rng.randint(-127, 128, (2, 6, H, W, 16)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, 3, 16, 32)).astype(np.int8)
    want = np.asarray(jl._conv3d_decomposed(jnp.asarray(xq), jnp.asarray(wq), stride))
    got = I.conv3d_int8(torch.from_numpy(xq), L.tf_to_torch(torch.from_numpy(wq)), stride, pads)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 2**16           # sums far past the integers fp16 holds exactly
    scale = torch.tensor(3.1e-5)
    scaled = I.conv3d_int8(torch.from_numpy(xq), L.tf_to_torch(torch.from_numpy(wq)), stride,
                           pads, scale, torch.bfloat16)
    np.testing.assert_array_equal(
        scaled.float().numpy(),
        np.asarray((jnp.asarray(want).astype(jnp.float32) * jnp.float32(3.1e-5))
                   .astype(jnp.bfloat16).astype(jnp.float32)))


def test_plain_int8_conv_on_a_depth_block_with_its_halo():
    """A block of planes that carries one halo plane on each side, at D pads (0, 0), gives
    the whole volume's output planes for that block (what a depth split computes)."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (1, 8, 5, 6, 8), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (8, 8, 3, 3, 3), generator=g, dtype=torch.int8)
    whole = I.conv3d_int8(xq, wq, 1, [(1, 1), (1, 1), (1, 1)])
    block = I.conv3d_int8(xq[:, 2:7].contiguous(), wq, 1, [(0, 0), (1, 1), (1, 1)])
    assert torch.equal(block, whole[:, 3:6])
    s2 = I.conv3d_int8(xq, wq, 2, [(0, 1), (0, 1), (0, 1)])
    block2 = I.conv3d_int8(xq[:, 4:].contiguous(), wq, 2, [(0, 1), (0, 1), (0, 1)])
    assert torch.equal(block2, s2[:, 2:])


def test_packed_weights_are_the_kernels_layout():
    g = torch.Generator().manual_seed(1)
    for co, ci in ((5, 6), (64, 64), (1, 8)):
        wq = torch.randint(-127, 128, (co, ci, 3, 3, 3), generator=g, dtype=torch.int8)
        pk = I.packed_weights(wq)
        ci4 = -(-ci // 4) * 4
        assert pk.shape == (-(-co // 8) * 8, -(-27 * ci4 // 32) * 32) and pk.is_contiguous()
        taps = pk[:co, :27 * ci4].reshape(co, 3, 3, 3, ci4)
        assert torch.equal(taps[..., :ci], wq.permute(0, 2, 3, 4, 1))
        assert not taps[..., ci:].any() and not pk[co:].any() and not pk[:, 27 * ci4:].any()
    assert I.output_shape((2, 6, 7, 9, 8), 16, 2, [(0, 1), (1, 1), (0, 1)]) == (2, 3, 4, 4, 16)


def test_the_kernel_wrapper_refuses_what_it_does_not_take():
    xq = torch.zeros((1, 4, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((8, 8, 3, 3, 3), dtype=torch.int8)
    pads = [(1, 1)] * 3
    with pytest.raises(ValueError, match="CUDA"):
        I.conv3d_int8_cuda(xq, wq, 1, pads)
    for bad in (dict(xq=xq.float()), dict(wq=wq[:, :4]), dict(stride=3),
                dict(wq=torch.zeros((8, 8, 1, 3, 3), dtype=torch.int8)),
                dict(scale=torch.tensor(1.0)), dict(out_dtype=torch.float16,
                                                    scale=torch.tensor(1.0))):
        kw = dict(xq=xq, wq=wq, stride=1, pads=pads) | bad
        with pytest.raises(ValueError):
            I.conv3d_int8(**kw)
    assert I.conv3d_int8_cuda.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bn_qin_matches_jax(dtype):
    x, w = _operands((1, 6, 8, 7), 16, 16, seed=5)
    x = np.maximum(x, 0)                       # a relu link's range
    xj = jnp.asarray(x).astype(dtype)
    tx, tw = _as_torch(xj, dtype), L.tf_to_torch(torch.from_numpy(w))
    with _mxu_scope():
        want = np.asarray(jl.conv_bn({"w": jnp.asarray(w)}, xj, qin=True).astype(jnp.float32))
        stored = np.asarray(jl.conv_bn({"w": jnp.asarray(w)}, xj).astype(jnp.float32))
    with numerics.scope(numerics.NumericsPolicy(act_quant="int8s")):
        int8s = np.asarray(jl.conv_bn({"w": jnp.asarray(w)}, xj).astype(jnp.float32))
    got = L.conv_bn(tx, tw, quant=MXU, qin=True).float().numpy()
    step = 6.0 / 255.0                         # the relu link's lattice step
    off = np.abs(got - want)
    if dtype == "float32":
        # fp32 reductions in another order: 1e-5, or one lattice step where that flips a
        # rounding of the link
        assert np.all((off <= 1e-5) | (np.abs(off - step) <= 1e-5)), off.max()
        assert np.mean(off > 1e-5) <= 1e-3
    else:
        # the normalized value rounds to bf16 before the link's lattice: one bf16 step of
        # a value below 2*R, or one lattice step
        assert off.max() <= step + 1e-5 and np.mean(off > 1e-5) <= 1e-2, off.max()
    # qin=False under int8mxu is int8s, in both packages
    np.testing.assert_array_equal(stored, int8s)
    np.testing.assert_array_equal(L.conv_bn(tx, tw, quant=MXU).float().numpy(),
                                  L.conv_bn(tx, tw, quant=L.ActQuant("int8s")).float().numpy())
    assert np.abs(got - L.conv_bn(tx, tw, quant=MXU).float().numpy()).max() > 0


def test_volume_ops_take_the_int8_route_only_where_jax_does():
    """A bias, a 4D input, a dilation, a mode other than int8mxu or qin=False keep the
    float conv; conv3d_mixed passes qin to its varying half."""
    x, w = _operands((1, 4, 6, 6), 8, 8, seed=2)
    tx, tw = torch.from_numpy(x), L.tf_to_torch(torch.from_numpy(w))
    plain = L.conv(tx, tw)
    for kw in (dict(quant=L.ActQuant("int8s")), dict(qin=False), dict(quant=None)):
        assert torch.equal(L.conv(tx, tw, **(dict(quant=MXU, qin=True) | kw)), plain)
    b = torch.zeros(8)
    assert torch.equal(L.conv(tx, tw, b=b, quant=MXU, qin=True), L.conv(tx, tw, b=b))
    assert torch.equal(L.conv(tx, tw, rate=2, quant=MXU, qin=True), L.conv(tx, tw, rate=2))
    assert not torch.equal(L.conv(tx, tw, quant=MXU, qin=True), plain)
    x4, w4 = tx[:, 0], tw[:, :, 0]
    assert torch.equal(L.conv(x4, w4, quant=MXU, qin=True), L.conv(x4, w4))
    c2 = torch.from_numpy(np.random.RandomState(3).randn(1, 6, 6, 2).astype(np.float32))
    wm = L.tf_to_torch(torch.from_numpy(np.random.RandomState(4).randn(3, 3, 3, 10, 8)
                                        .astype(np.float32) * 0.2))
    with _mxu_scope():
        want = jl.conv3d_mixed(jnp.asarray(L.torch_to_tf(wm).numpy()), jnp.asarray(x),
                               jnp.asarray(c2.numpy()), qin=True)
    got = L.conv3d_mixed(wm, tx, c2, quant=MXU, qin=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.abs(got.numpy() - L.conv3d_mixed(wm, tx, c2).numpy()).max() > 1e-3


def test_int8mxu_stages_match_jax_on_the_same_inputs():
    """Stage 1 (tvsnet_base: CRM both directions) and stage 3 (tvsnet_refine) of one pair,
    the port's and JAX's fed the same inputs: tests/test_torch_quant.py's stage bounds."""
    model, cams, feats, shallow, base = _stage_inputs()
    tree = _unflatten(export_jax_params(model))
    cfg, jcfg = PipelineConfig(**SIZE, act_quant="int8mxu"), JaxConfig(**SIZE, act_quant="int8mxu")
    ds, di = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    with numerics.scope(jcfg.numerics()):
        jb = jax.jit(lambda p: jt.tvsnet_base(p, feats[:, 0], feats[:, 1], cams[:, 0], cams[:, 1],
                                              jcfg, ds, di))(tree)
        jr = jax.jit(lambda p: jt.tvsnet_refine(
            p, base["depth"], base["depth_view"], base["prob_volume"], base["filtered_cost"],
            cams[:, 0], cams[:, 1], shallow[:, 0], shallow[:, 1], jcfg, ds, di))(tree)
    f, c, sh = torch.from_numpy(feats), torch.from_numpy(cams), torch.from_numpy(shallow)
    with torch.no_grad():
        tb = tt.tvsnet_base(model, f[:, 0], f[:, 1], c[:, 0], c[:, 1], cfg, c[:, 0, 1, 3, 0],
                            c[:, 0, 1, 3, 1])
        tr = tt.tvsnet_refine(model, *(torch.from_numpy(base[k]) for k in
                                       ("depth", "depth_view", "prob_volume", "filtered_cost")),
                              c[:, 0], c[:, 1], sh[:, 0], sh[:, 1], cfg, c[:, 0, 1, 3, 0],
                              c[:, 0, 1, 3, 1])
        int8s = tt.tvsnet_base(model, f[:, 0], f[:, 1], c[:, 0], c[:, 1],
                               cfg.replace(act_quant="int8s"), c[:, 0, 1, 3, 0], c[:, 0, 1, 3, 1])
    for got, want in ((tb.prob_volume, jb.prob_volume), (tb.filtered_cost, jb.filtered_cost),
                      (tr[0], jr[0]), (tr[1], jr[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VOLUME_TOL)
    for got, want in ((tb.depth, jb.depth), (tb.depth_view, jb.depth_view)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEPTH_TOL)
    # the int8 convs are on: int8s storage alone is elsewhere
    assert np.abs(int8s.prob_volume.numpy() - np.asarray(jb.prob_volume)).max() > 1e-2


@pytest.mark.parametrize("stage", [1, 2])
def test_int8mxu_aam_matches_jax_on_the_same_inputs(stage):
    """attention_aggregate_stacked and the output conv on a (P, B, D, h, w, C) stack of
    link sums: the int8 convs equal, the softmax over views in fp32."""
    model = _stage_inputs()[0]
    tree = _unflatten(export_jax_params(model))
    rng = np.random.RandomState(stage)
    step = 6.0 / 255.0
    stack = ((rng.randint(0, 160, (4, 1, 8, 8, 8, 8)) + rng.randint(0, 160, (4, 1, 8, 8, 8, 8)))
             * step).astype(np.float32)
    with _mxu_scope():
        agg = jt.aam_aggregate_stacked(tree, jnp.asarray(stack), stage)
        prob = jt.aam_output_conv(tree, agg, stage)
    with torch.no_grad():
        tagg = tt.aam_aggregate_stacked(model, torch.from_numpy(stack), stage, quant=MXU)
        tprob = tt.aam_output_conv(model, tagg, stage, quant=MXU)
        agg_none = tt.aam_aggregate_stacked(model, torch.from_numpy(stack), stage)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(agg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), rtol=1e-4, atol=5e-4)
    assert np.abs(agg_none.numpy() - np.asarray(agg)).max() > 1e-4


_cache = {}


def _trained_forwards(dtype):
    """(JAX's outputs, the port's, the port's on images moved by 1e-6 of their value,
    the port's under int8s) of the trained 3-view forward under int8mxu; one JAX jit per
    dtype."""
    if dtype not in _cache:
        scene = render_multiplane_scene(view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2)
        kw = dict(TRAINED, compute_dtype=dtype, act_quant="int8mxu")
        jcfg = JaxConfig(**kw)
        ref = jax.jit(lambda p, i, c: jax_forward(p, i, c, jcfg, upsample=False))(
            load_params(SPHERES), jnp.asarray(scene["images"]), jnp.asarray(scene["cams"]))
        cfg = PipelineConfig(**kw)
        model = load_model(SPHERES, cfg, device="cpu")

        def port(images, c=cfg):
            out = multi_view_forward(model, images, scene["cams"], c, upsample=False)
            return {k: out[k].float().numpy() for k in KEYS}

        noise = np.random.RandomState(7).randn(*scene["images"].shape)
        _cache[dtype] = ({k: np.asarray(ref[k], np.float32) for k in KEYS}, port(scene["images"]),
                         port((scene["images"] * (1 + 1e-6 * noise)).astype(np.float32)),
                         port(scene["images"], cfg.replace(act_quant="int8s")))
    return _cache[dtype]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8mxu_forward_matches_jax(dtype, key):
    ref, got, _, int8s = _trained_forwards(dtype)
    mean_bound, max_bound = BOUNDS[dtype]
    assert got[key].shape == ref[key].shape and np.isfinite(got[key]).all()
    diff = np.abs(got[key] - ref[key])
    assert diff.mean() <= mean_bound and diff.max() <= max_bound, (diff.mean(), diff.max())
    assert np.abs(int8s[key] - got[key]).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8mxu_forward_moves_under_image_noise_within_the_bounds(dtype):
    """The chaos the bounds allow for: the port's own int8mxu forward when its images
    change by 1e-6 of their value."""
    _, got, moved, _ = _trained_forwards(dtype)
    mean_bound, max_bound = BOUNDS[dtype]
    for key in KEYS:
        diff = np.abs(moved[key] - got[key])
        assert diff.mean() <= mean_bound and diff.max() <= max_bound, (key, diff.max())


def test_int8mxu_bucket_is_distinct_and_moves_the_depth():
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32, act_quant="int8s")
    est = DepthEstimator(cfg, device="cpu")
    mxu = est.add_bucket(act_quant="int8mxu")
    assert mxu.act_quant == "int8mxu" and len(est.buckets) == 2
    assert est.add_bucket(act_quant="int8mxu") == mxu and len(est.buckets) == 2
    images, cams = _scene_arrays(3, 32, 32, cfg.max_d, seed=5)
    base = est.predict(images, cams)
    got = DepthEstimator(mxu, device="cpu").predict(images, cams)
    assert np.isfinite(got["depth"]).all() and got["depth"].shape == base["depth"].shape
    assert np.abs(base["depth"] - got["depth"]).max() > 0


def test_eval_cli_runs_with_act_quant_int8mxu(tmp_path):
    write_eth3d_scene(str(tmp_path / "eth3d" / "s0"), 3, 64, 96, 0, num_d=16, num_spheres=2)
    proc = subprocess.run(
        [sys.executable, "-m", "atvsnet_torch.cli.eval_pointcloud", "--data_root", str(tmp_path),
         "--savepath", str(tmp_path / "out"), "--scenes", "s0", "--view_num", "3",
         "--max_d", "16", "--max_h", "64", "--max_w", "96", "--device", "cpu",
         "--load_workers", "1", "--write_workers", "1", "--act-quant", "int8mxu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "act_quant=int8mxu" in proc.stdout + proc.stderr
    folder = tmp_path / "out" / "s0" / "depths_atvsnet"
    depth = load_pfm(str(folder / "00000000.pfm"))
    assert np.isfinite(depth).all() and depth.max() > 0
