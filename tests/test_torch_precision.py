"""PipelineConfig.fp32_precision in the port against the JAX package's, on the CPU.

The JAX package maps the mode to lax.Precision for every conv and matmul leaf with a
float32 operand (atvsnet_tpu/nn/layers.py:39-53). XLA:CPU ignores the precision, so JAX is
run here with its `lax` and `jnp` names inside atvsnet_tpu.nn.layers replaced by a shim
that applies the TPU's bf16 pass arithmetic that `precision` names (monkeypatch; the JAX
package itself is not changed):

  HIGHEST  the op in full fp32;
  HIGH     a_hi b_hi + a_hi b_lo + a_lo b_hi, a_hi = bf16(a), a_lo = bf16(a - a_hi);
  DEFAULT  bf16(a) bf16(b);

each as fp32 ops on the exact bf16 pieces, in a jax.custom_vjp whose backward applies the
same arithmetic to both transposed ops (XLA's transpose rules carry the precision), so a
deconv (JAX's vjp of a conv) and every gradient take it too. The shim is held against a
numpy float64 evaluation of the same arithmetic.

  * config parity: the three modes, JAX's message on a wrong one; the port's pass ops
    against their own float64 plain versions, and the TF32 flags they scope;
  * every leaf kind (conv 2D / 3D / strided / dilated, fixed_pad_conv, deconv 2D / 3D,
    split_separable_conv2d, dense, conv3d_mixed) in "high" and "default" against JAX's
    under the shim: the forward and the gradient of every operand within max(2^-20, 4 e)
    of max sum |a||b|, e the distance between the two packages' "highest" results in the
    same case (the fp32-sum noise); and "default" lies more than 100x farther from
    "highest" than from JAX's, which a port that ignored the mode would fail;
  * the trained 3-view 64x96 D=32 fp32 forward in each mode against JAX's (one JAX jit
    per mode), with each package's own distance from "highest" beside the bound, and the
    port's own move under image noise, the chaos of bf16 rounding ties in "default";
  * what the mode leaves alone: a bf16 forward and an int8mxu qin conv are the same bits
    in every mode; a served bucket per mode.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax as jax_lax

from atvsnet_tpu import numerics
from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.data.synthetic import render_multiplane_scene
from atvsnet_tpu.models.atvsnet import multi_view_forward as jax_forward
from atvsnet_tpu.nn import layers as jl
from atvsnet_tpu.utils.ckpt import load_params
from atvsnet_torch.config import FP32_PRECISION_MODES, PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.models.atvsnet import multi_view_forward
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops import fp32_passes as P
from atvsnet_torch.params import load_model
from atvsnet_torch.serving import DepthEstimator

from tests.test_torch_serving import _scene_arrays

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
TRAINED = dict(view_num=3, max_d=32, max_h=64, max_w=96)
MODES = ("high", "default")
LEAF_FLOOR = 2.0 ** -20
KEYS = ("depth", "depth_agg_initial", "depth_views")


# ---- the TPU's pass arithmetic for JAX ----

def _bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def _pieces(f, mode, a, b):
    if mode == "default":
        return f(_bf16(a), _bf16(b))
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return f(ah, bh) + f(ah, bl) + f(al, bh)


def pass_bilinear(f, mode, a, b):
    """f(a, b), bilinear in full fp32, in the TPU's `mode` pass arithmetic; its vjp is the
    same arithmetic on each transposed op, itself differentiable the same way."""
    a_shape, b_shape = a.shape, b.shape

    @jax.custom_vjp
    def g(a, b):
        return _pieces(f, mode, a, b)

    def fwd(a, b):
        return g(a, b), (a, b)

    def bwd(res, ct):
        a, b = res

        def fa(ct_, b_):
            return jax.vjp(lambda a_: f(a_, b_), jnp.zeros(a_shape, jnp.float32))[1](ct_)[0]

        def fb(a_, ct_):
            return jax.vjp(lambda b_: f(a_, b_), jnp.zeros(b_shape, jnp.float32))[1](ct_)[0]

        return pass_bilinear(fa, mode, ct, b), pass_bilinear(fb, mode, a, ct)

    g.defvjp(fwd, bwd)
    return g(a, b)


_MODE_OF = {jax_lax.Precision.HIGH: "high", jax_lax.Precision.DEFAULT: "default"}


def _routed(op, lhs, rhs, precision, **kw):
    mode = _MODE_OF.get(precision)
    if mode is None or lhs.dtype != jnp.float32 or rhs.dtype != jnp.float32:
        return op(lhs, rhs, precision=precision, **kw)
    return pass_bilinear(lambda a, b: op(a, b, precision=jax_lax.Precision.HIGHEST, **kw),
                         mode, lhs, rhs)


class _Names:
    """A module's names with some replaced."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _conv_general_dilated(lhs, rhs, *args, precision=None, **kw):
    return _routed(lambda a, b, precision, **k: jax_lax.conv_general_dilated(
        a, b, *args, precision=precision, **k), lhs, rhs, precision, **kw)


def _matmul(a, b, precision=None):
    return _routed(jnp.matmul, a, b, precision)


@contextlib.contextmanager
def tpu_passes(monkeypatch, mode):
    """JAX's nn.layers with the TPU's pass arithmetic, under the `mode` policy."""
    with monkeypatch.context() as m:
        m.setattr(jl, "lax", _Names(jax_lax, conv_general_dilated=_conv_general_dilated))
        m.setattr(jl, "jnp", _Names(jnp, matmul=_matmul))
        with numerics.scope(numerics.NumericsPolicy(fp32_precision=mode)):
            yield


# ---- numpy float64 of the same arithmetic ----

def _np_pieces(a):
    hi = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    lo = (a - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
    return hi.astype(np.float64), lo.astype(np.float64)


def _np_passes(f, mode, a, b):
    (ah, al), (bh, bl) = _np_pieces(a), _np_pieces(b)
    if mode == "default":
        return f(ah, bh)
    return f(ah, bh) + f(ah, bl) + f(al, bh)


def _np_conv(x, w):
    """SAME stride-1 2D conv, NHWC by HWIO, k3: the sum of the nine shifted matmuls."""
    H, W = x.shape[1:3]
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return sum(xp[:, i:i + H, j:j + W] @ w[i, j] for i in range(3) for j in range(3))


def _np_conv_grad_x(g, w):
    H, W = g.shape[1:3]
    out = np.zeros(g.shape[:3] + (w.shape[2],))
    out = np.pad(out, ((0, 0), (1, 1), (1, 1), (0, 0)))
    for i in range(3):
        for j in range(3):
            out[:, i:i + H, j:j + W] += g @ w[i, j].T
    return out[:, 1:-1, 1:-1]


def _np_conv_grad_w(x, g):
    H, W = x.shape[1:3]
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return np.stack([np.stack([np.einsum("bhwc,bhwo->co", xp[:, i:i + H, j:j + W], g)
                               for j in range(3)]) for i in range(3)])


def _rel(got, want, scale):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(scale).max())


@pytest.mark.parametrize("mode", MODES)
def test_the_shim_is_the_pass_arithmetic(mode):
    """The shim's conv and matmul, forward and both gradients, against numpy float64 of the
    same pieces: the fp32 sums' noise only."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 9, 5).astype(np.float32)
    w = (rng.randn(3, 3, 5, 6) * 0.3).astype(np.float32)
    g = rng.randn(2, 7, 9, 6).astype(np.float32)

    def conv(a, b):
        return _conv_general_dilated(a, b, (1, 1), "SAME", dimension_numbers=jl._DIM_NUMBERS[2],
                                     precision=jl._FP32_PRECISION[mode])

    y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g))
    ax, aw, ag = np.abs(x).astype(np.float64), np.abs(w).astype(np.float64), np.abs(g).astype(np.float64)
    assert _rel(y, _np_passes(_np_conv, mode, x, w), _np_conv(ax, aw)) <= LEAF_FLOOR
    assert _rel(gx, _np_passes(_np_conv_grad_x, mode, g, w), _np_conv_grad_x(ag, aw)) <= LEAF_FLOOR
    assert _rel(gw, _np_passes(_np_conv_grad_w, mode, x, g), _np_conv_grad_w(ax, ag)) <= LEAF_FLOOR
    # the mode is on: bf16 pieces move the result far past the fp32 noise
    assert _rel(y, _np_conv(x.astype(np.float64), w.astype(np.float64)), _np_conv(ax, aw)) > (
        1e-4 if mode == "default" else 3e-7)

    a = rng.randn(3, 4, 33).astype(np.float32)
    b = rng.randn(33, 10).astype(np.float32)
    gm = rng.randn(3, 4, 10).astype(np.float32)
    y, vjp = jax.vjp(lambda p, q: _matmul(p, q, jl._FP32_PRECISION[mode]), jnp.asarray(a),
                     jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(gm))
    aa, ab, agm = (np.abs(t).astype(np.float64) for t in (a, b, gm))
    assert _rel(y, _np_passes(np.matmul, mode, a, b), aa @ ab) <= LEAF_FLOOR
    assert _rel(ga, _np_passes(lambda p, q: p @ q.T, mode, gm, b), agm @ ab.T) <= LEAF_FLOOR
    flat = (lambda t: t.reshape(-1, t.shape[-1]))
    assert _rel(gb, _np_passes(lambda p, q: flat(p).T @ flat(q), mode, a, gm),
                flat(aa).T @ flat(agm)) <= LEAF_FLOOR


# ---- config and the port's pass ops ----

def test_config_takes_the_modes_with_jaxs_message():
    for mode in FP32_PRECISION_MODES:
        assert PipelineConfig(fp32_precision=mode).fp32_precision == mode
    assert PipelineConfig().fp32_precision == "highest" == JaxConfig().fp32_precision
    assert FP32_PRECISION_MODES == numerics.FP32_PRECISION_MODES
    with pytest.raises(ValueError) as want:
        JaxConfig(fp32_precision="hi")
    with pytest.raises(ValueError) as got:
        PipelineConfig(fp32_precision="hi")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fp32_precision='hi'"):
        P.pass_matmul(torch.ones(2, 2), torch.ones(2, 2), "hi")


def _pass_cases():
    """(name, run(mode, a, b) -> out, plain(mode, a, b, g) -> dict, exact(a, b, g, magnitude),
    operand shapes)."""
    specs = {"conv3d": (P.ConvSpec.of(3, 1, 1), (1, 8, 6, 10, 12), (16, 8, 3, 3, 3)),
             "conv2d s2 dilated": (P.ConvSpec.of(2, 2, 2, 2), (2, 5, 15, 13), (6, 5, 3, 3)),
             "depthwise": (P.ConvSpec.of(2, 1, 2, 2, groups=6), (2, 6, 10, 10), (6, 1, 3, 3)),
             "transposed 3d": (P.ConvSpec.of(3, 2, transposed=True), (1, 16, 4, 6, 8),
                               (16, 8, 3, 3, 3))}
    cases = []
    for name, (spec, xs, ws) in specs.items():
        def run(mode, a, b, spec=spec):
            if spec.transposed:
                return P.pass_conv_transpose(a, b, mode, spec.stride)
            return P.pass_conv(a, b, mode, spec.stride, spec.padding, spec.dilation, spec.groups)
        cases.append((name, run, lambda m, a, b, g, spec=spec: P.conv_plain(a, b, m, spec, g),
                      lambda a, b, g, mag, spec=spec: P.conv_exact(a, b, spec, g, mag), xs, ws))
    cases.append(("matmul", lambda m, a, b: P.pass_matmul(a, b, m),
                  lambda m, a, b, g: P.matmul_plain(a, b, m, g), P.matmul_exact, (3, 5, 40),
                  (40, 7)))
    return cases


@pytest.mark.parametrize("case", _pass_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("mode", FP32_PRECISION_MODES)
def test_pass_ops_match_their_plain_versions(mode, case):
    """Each pass op, forward and both gradients, against its float64 plain version: the
    bound the card check uses, max(2^-20, 4 e) of max sum |a||b|, e the "highest" call's
    own error against the exact product; and "default" farther from exact than TF32
    would be (its 8-bit operands against TF32's 11)."""
    _, run, plain, exact, xs, ws = case
    gen = torch.Generator().manual_seed(3)
    a, b = torch.randn(xs, generator=gen), torch.randn(ws, generator=gen) * 0.3

    def leaf(m):
        ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = run(m, ar, br)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
        y.backward(g)
        return {"forward": y.detach(), "grad_input": ar.grad, "grad_weight": br.grad}, g

    got, g = leaf(mode)
    top, _ = leaf("highest")
    ref, ex = plain(mode, a, b, g), exact(a, b, g, False)
    scale = exact(a, b, g, True)
    for k in got:
        s = float(scale[k].max())
        e = float((top[k].double() - ex[k]).abs().max()) / s
        err = float((got[k].double() - ref[k]).abs().max()) / s
        assert err <= max(LEAF_FLOOR, 4 * e), (k, err, e)
        moved = float((got[k].double() - ex[k]).abs().max()) / s
        assert moved > {"highest": -1.0, "high": 2 * e, "default": 1e-4}[mode], (k, moved)


def test_each_call_scopes_tf32_forward_and_backward(monkeypatch):
    """The flags the ops see inside forward and backward, per mode, and that every call
    leaves them as it found them (on the CPU they are plain flags: no TF32 happens)."""
    seen = []
    for name in ("forward", "backward", "grad_input", "grad_weight"):
        orig = getattr(P.ConvSpec, name)

        def spy(self, *args, _orig=orig, _name=name):
            seen.append((_name, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return _orig(self, *args)
        monkeypatch.setattr(P.ConvSpec, name, spy)
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for flags in ((True, False), (False, True)):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        try:
            for mode in FP32_PRECISION_MODES:
                seen.clear()
                x = torch.randn(1, 3, 6, 6, requires_grad=True)
                w = torch.randn(4, 3, 3, 3, requires_grad=True)
                P.pass_conv(x, w, mode, 1, 1).sum().backward()
                on = mode != "highest"
                # "highest" runs aten's own backward, the modes their two gradients on it
                assert {s[0] for s in seen} == ({"forward", "backward"} | (
                    {"grad_input", "grad_weight"} if on else set()))
                assert all(s[1:] == (on, on) for s in seen), (mode, seen)
                assert (torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32) == flags
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


# ---- every leaf kind against JAX's under the shim ----

def _tf(shape, rng, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# name: (operand shapes in the JAX package's layout, jax fn, port fn(precision, *ops),
# to_port per operand)
KERNEL, SAME = L.tf_to_torch, (lambda t: t)
LEAVES = {
    "conv 2d": ([(2, 9, 11, 5), (3, 3, 5, 7)], lambda x, w: jl.conv(x, w),
                lambda p, x, w: L.conv(x, w, precision=p), (SAME, KERNEL)),
    "conv 2d s2": ([(1, 10, 12, 4), (3, 3, 4, 6)], lambda x, w: jl.conv(x, w, stride=2),
                   lambda p, x, w: L.conv(x, w, stride=2, precision=p), (SAME, KERNEL)),
    "conv 2d rate 2": ([(1, 9, 10, 6), (3, 3, 6, 6)], lambda x, w: jl.conv(x, w, rate=2),
                       lambda p, x, w: L.conv(x, w, rate=2, precision=p), (SAME, KERNEL)),
    "conv 3d": ([(1, 6, 8, 10, 4), (3, 3, 3, 4, 6)], lambda x, w: jl.conv(x, w),
                lambda p, x, w: L.conv(x, w, precision=p), (SAME, KERNEL)),
    "conv 3d s2": ([(1, 6, 8, 10, 4), (3, 3, 3, 4, 8)], lambda x, w: jl.conv(x, w, stride=2),
                   lambda p, x, w: L.conv(x, w, stride=2, precision=p), (SAME, KERNEL)),
    "fixed_pad_conv": ([(1, 10, 11, 5), (3, 3, 5, 6)], lambda x, w: jl.fixed_pad_conv(x, w),
                       lambda p, x, w: L.fixed_pad_conv(x, w, precision=p), (SAME, KERNEL)),
    "deconv 3d": ([(1, 3, 4, 5, 8), (3, 3, 3, 4, 8)], lambda x, w: jl.deconv(x, w),
                  lambda p, x, w: L.deconv(x, w, precision=p), (SAME, KERNEL)),
    "deconv 2d": ([(1, 5, 6, 8), (3, 3, 4, 8)], lambda x, w: jl.deconv(x, w),
                  lambda p, x, w: L.deconv(x, w, precision=p), (SAME, KERNEL)),
    "split_separable_conv2d": (
        [(2, 8, 9, 6), (3, 3, 6, 1), (1, 1, 6, 5)],
        lambda x, dw, pw: jl.split_separable_conv2d(x, dw, pw, rate=2),
        lambda p, x, dw, pw: L.split_separable_conv2d(x, dw, pw, rate=2, precision=p),
        (SAME, KERNEL, KERNEL)),
    "dense": ([(3, 4, 24), (24, 10)], lambda x, w: jl.dense(x, w, relu=False),
              lambda p, x, w: L.dense(x, w, relu=False, precision=p), (SAME, SAME)),
    "conv3d_mixed": ([(1, 6, 8, 10, 4), (1, 8, 10, 3), (3, 3, 3, 7, 6)],
                     lambda v, c, w: jl.conv3d_mixed(w, v, c),
                     lambda p, v, c, w: L.conv3d_mixed(w, v, c, precision=p),
                     (SAME, SAME, KERNEL)),
    "conv3d_mixed s2": ([(1, 6, 8, 10, 4), (1, 8, 10, 3), (3, 3, 3, 7, 6)],
                        lambda v, c, w: jl.conv3d_mixed(w, v, c, stride=2),
                        lambda p, v, c, w: L.conv3d_mixed(w, v, c, stride=2, precision=p),
                        (SAME, SAME, KERNEL)),
}


def _operands(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    return [_tf(s, rng, 1.0 if i == 0 or name.startswith("conv3d_mixed") and i == 1 else 0.3)
            for i, s in enumerate(LEAVES[name][0])]


def _jax_leaf(name, mode, ops, ct, monkeypatch):
    """JAX's outputs and the vjp of every operand, under the shim in `mode`."""
    fn = LEAVES[name][1]
    with tpu_passes(monkeypatch, mode):
        y, vjp = jax.vjp(fn, *map(jnp.asarray, ops))
        grads = vjp(jnp.asarray(ct))
    return [np.asarray(y, np.float64)] + [np.asarray(g, np.float64) for g in grads]


def _port_leaf(name, mode, ops, ct):
    """The port's outputs and the gradient of every operand, in the JAX layout."""
    _, _, fn, conv = LEAVES[name]
    ts = [c(torch.from_numpy(o)).requires_grad_() for o, c in zip(ops, conv)]
    y = fn(mode, *ts)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(ct))
    back = [SAME if c is SAME else L.torch_to_tf for c in conv]
    return [y.detach().double().numpy()] + [b(g).double().numpy() for b, g in zip(back, grads)]


_leaf_cache = {}


def _leaf(name, monkeypatch):
    """{mode: (JAX's, the port's)} of every mode, and the scale max sum |a||b| of each
    output: the port's "highest" leaf on the operands' absolute values, the cotangent's
    absolute value through it."""
    if name not in _leaf_cache:
        ops = _operands(name)
        with torch.no_grad():
            conv = LEAVES[name][3]
            shape = LEAVES[name][2]("highest", *[c(torch.from_numpy(o)) for o, c in
                                                 zip(ops, conv)]).shape
        ct = np.random.RandomState(5).randn(*shape).astype(np.float32)
        out = {m: (_jax_leaf(name, m, ops, ct, monkeypatch), _port_leaf(name, m, ops, ct))
               for m in FP32_PRECISION_MODES}
        scale = _port_leaf(name, "highest", [np.abs(o) for o in ops], np.abs(ct))
        _leaf_cache[name] = out, [float(np.abs(s).max()) for s in scale]
    return _leaf_cache[name]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(LEAVES))
def test_leaf_matches_jax_under_the_tpu_passes(name, mode, monkeypatch):
    out, scale = _leaf(name, monkeypatch)
    jax_top, port_top = out["highest"]
    jax_got, port_got = out[mode]
    for i, s in enumerate(scale):
        e = float(np.abs(port_top[i] - jax_top[i]).max()) / s
        err = float(np.abs(port_got[i] - jax_got[i]).max()) / s
        assert err <= max(LEAF_FLOOR, 4 * e), (i, err, e)
        if mode == "default":
            # the mode is on in both: far from "highest", close to each other
            moved = float(np.abs(port_got[i] - port_top[i]).max()) / s
            assert moved > 100 * err, (i, moved, err)
            assert float(np.abs(jax_got[i] - jax_top[i]).max()) / s > 100 * err


# ---- the trained forward ----

_fwd_cache = {}


def _forwards(mode, monkeypatch):
    """(JAX's, the port's) outputs of the trained 3-view forward in `mode`; one JAX jit."""
    if mode not in _fwd_cache:
        scene = _fwd_cache.setdefault("scene", render_multiplane_scene(
            view_num=3, H=64, W=96, D=32, seed=11, num_spheres=2))
        jcfg = JaxConfig(**TRAINED, fp32_precision=mode)
        with tpu_passes(monkeypatch, "highest"):
            ref = jax.jit(lambda p, i, c: jax_forward(p, i, c, jcfg, upsample=False))(
                load_params(SPHERES), jnp.asarray(scene["images"]), jnp.asarray(scene["cams"]))
        cfg = PipelineConfig(**TRAINED, fp32_precision=mode)
        model = _fwd_cache.setdefault("model", load_model(SPHERES, cfg, device="cpu"))
        got = multi_view_forward(model, scene["images"], scene["cams"], cfg, upsample=False)
        _fwd_cache[mode] = ({k: np.asarray(ref[k], np.float64) for k in KEYS},
                            {k: got[k].double().numpy() for k in KEYS})
    return _fwd_cache[mode]


# In sweep units (the interval is 1/32 of the inverse-depth range), mean / max over the
# output, worst of the three keys. Measured on the CPU (torch 2.13, jax 0.9.0): the port
# against JAX in "highest" 2.9e-7 / 3.6e-6, in "high" 4.9e-7 / 8.3e-6, in "default"
# 9.6e-5 / 1.3e-3. Each package's own move from its "highest": "high" 4.8e-7 / 3.6e-6
# (fp32 noise: the trained softmax is peaked, so only the leaves show "high"), "default"
# 2.9e-4 / 1.7e-3 (port) and 3.3e-4 / 2.7e-3 (JAX). In "default" every conv rounds its
# operands to bf16, so an fp32-noise difference that crosses a bf16 rounding tie moves a
# value by a bf16 step: the port's own "default" forward moves 1.5e-4 / 1.8e-3 when its
# images change by 1e-6 of their value ("highest": 1.7e-7 / 1.3e-6). Bounds: "highest" and
# "high" the fp32 forward's (tests/test_torch_forward_trained.py, 2e-5 max); "default"
# ~3x the larger of its gap and the port's own move under image noise.
FORWARD_BOUNDS = {"highest": (2e-6, 2e-5), "high": (2e-6, 2e-5), "default": (4e-4, 6e-3)}


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("mode", FP32_PRECISION_MODES)
def test_trained_forward_matches_jax_in_each_mode(mode, key, monkeypatch):
    ref, got = _forwards(mode, monkeypatch)
    mean_bound, max_bound = FORWARD_BOUNDS[mode]
    assert got[key].shape == ref[key].shape and np.isfinite(got[key]).all()
    diff = np.abs(got[key] - ref[key])
    assert diff.mean() <= mean_bound and diff.max() <= max_bound, (diff.mean(), diff.max())


def test_default_moves_each_packages_forward_from_highest(monkeypatch):
    """The mode is on in both packages: "default" moves each forward from its own
    "highest" by more than 100x the two packages' gap in "highest" (port and shim alike;
    a port that ignored the mode would not move at all)."""
    ref_top, got_top = _forwards("highest", monkeypatch)
    ref, got = _forwards("default", monkeypatch)
    for key in KEYS:
        gap = np.abs(got_top[key] - ref_top[key]).mean()
        assert np.abs(got[key] - got_top[key]).mean() > 100 * gap, key
        assert np.abs(ref[key] - ref_top[key]).mean() > 100 * gap, key


def test_the_ports_default_forward_moves_under_image_noise_within_the_bound(monkeypatch):
    """The chaos the "default" bound allows for: the port's own forward when its images
    change by 1e-6 of their value."""
    _, got = _forwards("default", monkeypatch)
    scene, model = _fwd_cache["scene"], _fwd_cache["model"]
    noise = np.random.RandomState(7).randn(*scene["images"].shape)
    cfg = PipelineConfig(**TRAINED, fp32_precision="default")
    moved = multi_view_forward(model, (scene["images"] * (1 + 1e-6 * noise)).astype(np.float32),
                               scene["cams"], cfg, upsample=False)
    mean_bound, max_bound = FORWARD_BOUNDS["default"]
    for key in KEYS:
        diff = np.abs(moved[key].double().numpy() - got[key])
        assert 0 < diff.max() <= max_bound and diff.mean() <= mean_bound, (key, diff.max())


# ---- what the mode leaves alone ----

def test_bf16_forward_is_the_same_bits_in_every_mode():
    images, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=5)
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32, compute_dtype="bfloat16")
    model = load_model(SPHERES, cfg, device="cpu")
    outs = [multi_view_forward(model, images, cams, cfg.replace(fp32_precision=m),
                               upsample=False)
            for m in FP32_PRECISION_MODES]
    for out in outs[1:]:
        for k in KEYS:
            assert torch.equal(out[k], outs[0][k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8mxu_qin_conv_is_the_same_bits_in_every_mode(dtype):
    gen = torch.Generator().manual_seed(9)
    x = (torch.randn(1, 6, 8, 10, 8, generator=gen) * 2).to(dtype)
    w = torch.randn(16, 8, 3, 3, 3, generator=gen) * 0.2
    mxu = L.ActQuant("int8mxu")
    outs = [L.conv(x, w, stride=s, quant=mxu, qin=True, precision=m)
            for s in (1, 2) for m in FP32_PRECISION_MODES]
    for i in (1, 2):
        assert torch.equal(outs[i], outs[0])
        assert torch.equal(outs[3 + i], outs[3])
    # the float route does take the mode
    if dtype == torch.float32:
        floats = [L.conv(x, w, precision=m) for m in FP32_PRECISION_MODES]
        assert not torch.equal(floats[0], floats[2])


def test_buckets_that_differ_only_in_the_mode_stay_apart():
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    est = DepthEstimator(cfg, device="cpu")
    default = est.add_bucket(fp32_precision="default")
    high = est.add_bucket(fp32_precision="high")
    assert len(est.buckets) == 3 and len({cfg, default, high}) == 3
    assert est.add_bucket(fp32_precision="default") == default and len(est.buckets) == 3
    images, cams = _scene_arrays(3, 32, 32, cfg.max_d, seed=5)
    base = est.predict(images, cams)["depth"]
    got = DepthEstimator(default, device="cpu").predict(images, cams)["depth"]
    assert np.isfinite(got).all() and got.shape == base.shape
    assert np.abs(got - base).max() > 0
