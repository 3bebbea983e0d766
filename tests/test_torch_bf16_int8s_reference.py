"""The JAX package's speed mode in the port, compute_dtype="bfloat16" with act_quant="int8s"
and warp_quant="int8", against the plain reference of the benchmark
(benchmark/reference/bf16_int8s.py), on the CPU: the reference that decides `correct` in the
cell serve5.bf16_int8s.

One test, in cases, on seeded random weights at 3 views, 64x96, D=16: the port's forward
against the reference, depth and confidence, at the cost volume's resolution and
upsampled; one CRM pass on the port's own features, where the port in the mode matches the
reference and the port without either lattice, with one of them, or at float32 is told
apart from it; under a recording session, the port's counts of link and sweep-volume
elements equal to the reference's count of what went through its lattices, and the port's
bf16 conv leaves, counted by shape, equal to the reference's leaf calls; and the
reference's rounding and its scope on hand cases. This file imports no JAX.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models import tvsnet
from atvsnet_torch.models.atvsnet import center_images, multi_view_forward
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops.fp32_passes import ConvSpec
from atvsnet_torch.params import init_model
from atvsnet_torch.utils.profiling import TRACER
from benchmark import scenes
from benchmark.reference import bf16_int8s
from benchmark.reference import model as ref_model
from benchmark.reference import preprocess

VIEWS, H, W, D = 3, 64, 96, 16
OUTPUTS = ("depth", "confidence", "depth_up", "confidence_up")
MODE = dict(compute_dtype="bfloat16", act_quant="int8s", warp_quant="int8")
# Tolerances of the forward's mean gaps, in planes of the sweep for depth and as they are
# for confidence. Both sides round the same values at the same points, but sum in another
# order (oneDNN's bf16 convs here against aten's fp32 convs of the bf16 values): a value
# within an fp32 ulp of a bf16 tie, or of a link's lattice boundary, lands one step apart,
# and random weights carry such a step far through the U-Nets. Over 4 cases of random
# weights and scenes (this file's first) the gap read 0.062-0.081 planes and 0.013-0.020
# in confidence; the port's own forward moved by 0.069-0.099 and 0.014-0.023 when its
# images moved by 1e-3: the gap is that chaos. The reference with 6 significant bits in
# place of bf16's 8 (the cell's control (a)) read 0.21-0.26 planes from it.
DEPTH_MEAN_PLANES = 0.15
CONF_MEAN = 0.03
# One CRM pass on the port's own features, the filtered volume's mean gap over its mean
# magnitude: the port in the mode read 0-0.010 against the reference over the same 4 cases
# (0 here: the reference's bits); without either lattice, with only one, or at float32 it
# read 0.019-0.028.
CRM_SAME = 0.005
CRM_APART = 0.015


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(2)
    rig = scenes.render_rig(VIEWS, H, W, 11)
    prep = preprocess.prepare(list(scenes.frames_uint8(rig)), list(scenes.rig_cams(rig, 128)),
                              VIEWS, max_d=D, max_h=H, max_w=W)
    model = init_model(PipelineConfig(view_num=VIEWS, max_d=D, max_h=H, max_w=W), 3, "cpu")
    weights = {n.replace(".", "/"): t.detach() for n, t in model.named_parameters()}
    return model, weights, torch.from_numpy(prep["images"]), prep["cams"]


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _cfg(**kw):
    return PipelineConfig(view_num=VIEWS, max_d=D, max_h=H, max_w=W, **kw)


def _port(case, **kw):
    model, _, images, cams = case
    return multi_view_forward(model, center_images(images), cams, _cfg(**kw), out_prob_map=True)


def _reference(case, bits=8):
    _, weights, images, cams = case
    return bf16_int8s.forward(weights, ref_model.center_images(images), torch.from_numpy(cams),
                              D, bits=bits)


def _gaps(got, want, cams):
    """{output: mean gap}, depths in planes."""
    interval = float(cams[0, 0, 1, 3, 1])
    return {k: ((got[k].float() - want[k]).abs().mean()
                / (interval if k.startswith("depth") else 1.0)).item() for k in OUTPUTS}


def _limit(k):
    return DEPTH_MEAN_PLANES if k.startswith("depth") else CONF_MEAN


def _forward(case):
    want = _reference(case)
    for k, gap in _gaps(_port(case, **MODE), want, case[3]).items():
        assert gap < _limit(k), (k, gap)
    # the control: 6 significant bits in the reference's place fail the depth limit
    gaps = _gaps(_reference(case, bits=6), want, case[3])
    assert gaps["depth"] > _limit("depth"), gaps


def _crm_apart(case):
    model, weights, images, cams = case
    cams = torch.from_numpy(cams)
    start, interval = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    feats = tvsnet.extract_features(model, center_images(images), _cfg(**MODE))
    with bf16_int8s.bf16_leaves():
        hom = ref_model.homographies(cams[:, 0], cams[:, 1], D, start, interval)
        filtered, _ = bf16_int8s.crm(weights, bf16_int8s.sweep_warp(feats[:, 1], hom),
                                        feats[:, 0], 6.0)

    def gaps(**kw):
        cfg = _cfg(**kw)
        f = feats.to(cfg.dtype)
        out = tvsnet.tvsnet_base(model, f[:, 0], f[:, 1], cams[:, 0], cams[:, 1], cfg, start,
                                 interval)
        return ((out.filtered_cost.float() - filtered.float()).abs().mean()
                / filtered.float().abs().mean()).item()

    assert gaps(**MODE) < CRM_SAME
    for kw in (dict(compute_dtype="bfloat16"), dict(compute_dtype="bfloat16", act_quant="int8s"),
               dict(compute_dtype="bfloat16", warp_quant="int8"),
               dict(act_quant="int8s", warp_quant="int8")):
        assert gaps(**kw) > CRM_APART, kw


def _lattice_counts(case):
    """Under a recording session the port counts every link's and every CRM sweep volume's
    elements; the reference's two lattice functions see the same numbers, so a port that
    skipped a round trip would fail here where the forward's gaps cannot tell."""
    before = {k: TRACER.counters.get(f"quant.{k}.elements", 0) for k in ("act", "warp")}
    with _session():
        _port(case, **MODE)
    port = {k: TRACER.counters.get(f"quant.{k}.elements", 0) - before[k] for k in before}
    ref = {"act": 0, "warp": 0}

    def counted(kind, lattice):
        def wrapped(t, *args):
            ref[kind] += t.numel()
            return lattice(t, *args)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bf16_int8s, "link", counted("act", bf16_int8s.link))
        mp.setattr(bf16_int8s, "quantize_warp", counted("warp", bf16_int8s.quantize_warp))
        _reference(case)
    # 2 pairs x 2 directions of CRM, one sweep volume of 16 planes of 16 x 24 x 32 each
    assert port["warp"] == 4 * D * 16 * 24 * 32
    assert port == ref


def _leaf_launches(case):
    """The port's bf16 conv leaves, counted by shape under a session, are the reference's
    leaf calls, kind by kind and key by key."""
    calls = collections.Counter()

    def logged(nd, leaf, transposed):
        def wrapped(x, w, *args, **kw):         # args: the bias; kw: the geometry
            kind = "conv_transpose" if transposed else f"conv{nd}d"
            spec = ConvSpec.of(nd, transposed=transposed, **kw)
            calls[(kind, tuple(x.shape), tuple(w.shape), spec.stride, spec.padding,
                   spec.dilation, spec.groups)] += 1
            return leaf(x, w, *args, **kw)
        return wrapped

    L.reset_launch_counts()
    try:
        with _session():
            _port(case, **MODE)
        port = dict(L.bf16_conv.shape_launches)
        with pytest.MonkeyPatch.context() as mp:
            for nd in (2, 3):
                mp.setitem(ref_model._CONV, nd, logged(nd, ref_model._CONV[nd], False))
                mp.setitem(ref_model._CONV_T, nd, logged(nd, ref_model._CONV_T[nd], True))
            _reference(case)
        assert L.bf16_conv.path_launches["conv_transpose"] == 4 * 9 + 2 * 3
        assert port == dict(calls)
    finally:
        L.reset_launch_counts()


def _rounding_hand_cases(case):
    # 8 bits is bf16's own rounding; 6 keep 1 + 5 bits: 1 + 2^-6 is a tie between 1 and
    # 1 + 2^-5 and goes to the even 1, 1 + 3 * 2^-6 to 1 + 2^-4, negatives by magnitude
    x = torch.randn(4096, generator=torch.Generator().manual_seed(5)) * 1e3
    assert torch.equal(bf16_int8s.round_bits(x, 8), x.to(torch.bfloat16))
    hand = torch.tensor([1 + 2 ** -6, 1 + 3 * 2 ** -6, -(1 + 3 * 2 ** -6), 1 + 2 ** -6 + 2 ** -20,
                         0.0, 3.0])
    assert bf16_int8s.round_bits(hand, 6).float().tolist() == [
        1.0, 1 + 2 ** -4, -(1 + 2 ** -4), 1 + 2 ** -5, 0.0, 3.0]
    # the leaves round the product once, add the bias in bf16, take only bf16 activations,
    # and only inside the scope, with TF32 off there and as it was afterwards
    xs = torch.full((1, 1, 1, 1), 1 + 2 ** -7, dtype=torch.bfloat16)
    ws = torch.full((1, 1, 1, 1), 1 + 2 ** -7)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with bf16_int8s.bf16_leaves():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        # (1 + 2^-7)^2 = 1 + 2^-6 + 2^-14 rounds to 1 + 2^-6; + 2^-8 is then a tie, to even
        y = ref_model._CONV[2](xs, ws, torch.tensor([2 ** -8]))
        assert y.dtype == torch.bfloat16 and y.item() == 1 + 2 ** -6
        assert ref_model._CONV_T[2](xs, ws).item() == 1 + 2 ** -6
        with pytest.raises(TypeError):
            ref_model._CONV[2](xs.float(), ws)
    assert ref_model._CONV[2](xs.float(), ws).item() == (1 + 2 ** -7) ** 2
    assert ref_model.batch_norm is not bf16_int8s.batch_norm
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


CASES = {"forward": _forward, "crm_apart": _crm_apart, "lattice_counts": _lattice_counts,
         "leaf_launches": _leaf_launches, "rounding_hand_cases": _rounding_hand_cases}


@pytest.mark.parametrize("name", list(CASES))
def test_the_port_against_the_bf16_int8s_reference(case, name):
    CASES[name](case)
