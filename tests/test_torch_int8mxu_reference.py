"""act_quant="int8mxu" in the port against the plain int8mxu reference of the benchmark
(benchmark/reference/int8mxu.py), on the CPU: the reference that decides `correct` in the
cell serve5.int8mxu.

One test, in cases: the port's forward (on conv3d_int8_torch, the CPU path of the int8 conv)
against the reference on seeded random weights at 3 views, 64x96, D=16; the qin sites and
the quantized links of both, call by call; the reference's quantization on hand cases; and
act_quant="int8s", whose convs are float, told apart from int8mxu at that size. This file
imports no JAX.
"""

import numpy as np
import pytest
import torch

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models.atvsnet import center_images, multi_view_forward
from atvsnet_torch.nn import layers as L
from atvsnet_torch.ops.int8_conv import conv3d_int8
from atvsnet_torch.params import init_model
from benchmark import scenes
from benchmark.reference import int8mxu
from benchmark.reference import model as ref_model
from benchmark.reference import preprocess

VIEWS, H, W, D = 3, 64, 96, 16
OUTPUTS = ("depth", "confidence", "depth_up", "confidence_up")
# Tolerances of the forward, in planes of the sweep for depth and as they are for
# confidence. The integer sums are exact on both sides, and every quantized tensor is the
# same function of its input (the case "sites" holds each to the bit); what differs is the
# order of the float convs' sums. A link whose value before rounding lies within an fp32
# ulp of a rounding boundary then lands one lattice step apart (0.024 or 0.047), and the
# step cascades through the U-Nets that follow. At this size that moved the mean depth by
# 0 to 0.048 planes over 6 cases of random weights and scenes, and the mean confidence by
# at most 0.0083; int8s and none moved them by 0.07-0.14 and 0.013-0.026.
DEPTH_MEAN_PLANES = 0.06
CONF_MEAN = 0.01


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(2)
    rig = scenes.render_rig(VIEWS, H, W, 11)
    prep = preprocess.prepare(list(scenes.frames_uint8(rig)), list(scenes.rig_cams(rig, 128)),
                              VIEWS, max_d=D, max_h=H, max_w=W)
    model = init_model(PipelineConfig(view_num=VIEWS, max_d=D, max_h=H, max_w=W), 3, "cpu")
    weights = {n.replace(".", "/"): t.detach() for n, t in model.named_parameters()}
    images = torch.from_numpy(prep["images"])
    return model, weights, images, prep["cams"]


def _port(case, mode, **kw):
    model, _, images, cams = case
    cfg = PipelineConfig(view_num=VIEWS, max_d=D, max_h=H, max_w=W, act_quant=mode, **kw)
    return multi_view_forward(model, center_images(images), cams, cfg, out_prob_map=True)


def _reference(case, act_range=6.0):
    _, weights, images, cams = case
    return int8mxu.forward(weights, ref_model.center_images(images), torch.from_numpy(cams), D,
                           act_range)


def _gaps(got, want, cams):
    """{output: mean gap}, depths in planes."""
    interval = float(cams[0, 0, 1, 3, 1])
    return {k: ((got[k] - want[k]).abs().mean() / (interval if k.startswith("depth") else 1.0))
            .item() for k in OUTPUTS}


def _forward(case):
    gaps = _gaps(_port(case, "int8mxu"), _reference(case), case[3])
    for k, gap in gaps.items():
        assert gap < (DEPTH_MEAN_PLANES if k.startswith("depth") else CONF_MEAN), (k, gap)


def _range(case):
    # act_quant_range reaches both: the same forward at 4.0
    gaps = _gaps(_port(case, "int8mxu", act_quant_range=4.0), _reference(case, 4.0), case[3])
    assert max(gaps.values()) < DEPTH_MEAN_PLANES, gaps


def _sites(case):
    """Every quantized link and every qin conv, in order: the input's shape, and the kernel's
    shape and output scale, the same in both, call for call; and each of the port's, given
    the port's own input, equal to the bit to the reference's function of that input."""
    port, ref = {"links": [], "qin": []}, {"links": [], "qin": []}
    forced = []         # (the reference's function, its input, the port's value) at each site
    ref_link, ref_qconv = int8mxu.quantize_act, int8mxu.qconv

    def link(calls, fn):
        def wrapped(y, quant, **kw):
            out = fn(y, quant, **kw)
            if y.ndim == 5 and quant is not None:
                calls["links"].append(tuple(y.shape))
                if calls is port:
                    forced.append((ref_link, (y, 6.0, kw["nonneg"]), out))
            return out
        return wrapped

    def operands(calls, fn):
        def wrapped(x, w, act_range):
            out = fn(x, w, act_range)
            calls["qin"].append((tuple(x.shape), tuple(w.shape), out[2].item()))
            return out
        return wrapped

    operand_args = []

    def port_conv(xq, wq, stride, pads, scale, out_dtype):
        out = conv3d_int8(xq, wq, stride, pads, scale, out_dtype)
        x, w = operand_args.pop()
        forced.append((ref_qconv, (x, w, 6.0, stride), out))
        return out

    def port_operands(x, w, act_range):
        operand_args.append((x, w))
        return L_operands(x, w, act_range)

    L_operands = operands(port, L.quant_conv_operands)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "quantize_act", link(port, L.quantize_act))
        mp.setattr(L, "quant_conv_operands", port_operands)
        mp.setattr(L, "conv3d_int8", port_conv)
        mp.setattr(int8mxu, "quantize_act", link(ref, int8mxu.quantize_act))
        mp.setattr(int8mxu, "quant_operands", operands(ref, int8mxu.quant_operands))
        _port(case, "int8mxu")
        _reference(case)
    # per CRM pass (2 pairs x 2 directions) 30 links and 20 qin convs; per refinement (2)
    # 14 links and 8 qin convs; the two AAMs 2 qin convs each
    assert len(port["links"]) == 4 * 30 + 2 * 14 and len(port["qin"]) == 4 * 20 + 2 * 8 + 4
    assert port == ref
    assert len(forced) == len(port["links"]) + len(port["qin"])
    for k, (fn, args, got) in enumerate(forced):
        assert torch.equal(fn(*args), got), k


def _operand_hand_cases(case):
    # si = 1 at range 127: x rounds half to even and clips at +-127; w's max is 127, so sw
    # = 1 + 1e-12, which is 1 in float32
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.4, 300.0, -300.0])
    w = torch.tensor([127.0, -63.5, 0.5, 1.5, -2.5, 64.5])
    xq, wq, scale = int8mxu.quant_operands(x, w, 127.0)
    assert xq.tolist() == [0, 2, 2, 0, -2, -2, 126, 127, 127, -127]
    assert wq.tolist() == [127, -64, 0, 2, -2, 64] and scale.item() == 1.0
    pxq, pwq, pscale = L.quant_conv_operands(x, w, 127.0)
    assert torch.equal(pxq.float(), xq) and torch.equal(pwq.float(), wq)
    assert torch.equal(pscale, scale)
    # a kernel of max|w| 0.254: sw = 0.002, and 0.001 (half a step) rounds to 0
    xq, wq, scale = int8mxu.quant_operands(x, torch.tensor([0.254, -0.001, 0.003]), 6.0)
    assert wq.tolist() == [127, 0, 2]
    assert scale.item() == pytest.approx(6.0 / 127 * 0.002, rel=1e-6)


def _link_hand_cases(case):
    relu = torch.tensor([-3.0, 0.5, 1.5, 2.5, 254.5, 300.0]).reshape(1, 1, 1, 6, 1)
    assert int8mxu.quantize_act(relu, 255.0).flatten().tolist() == [0, 0, 2, 2, 254, 255]
    signed = torch.tensor([-200.0, -0.5, -1.5, 2.5, 126.5]).reshape(1, 1, 1, 5, 1)
    assert int8mxu.quantize_act(signed, 127.0, nonneg=False).flatten().tolist() == \
        [-127, 0, -2, 2, 126]
    y = torch.from_numpy(np.random.default_rng(0).normal(0, 2, (1, 2, 3, 4, 5)).astype(np.float32))
    for nonneg in (True, False):
        want = L.quantize_act(y.clamp(min=0) if nonneg else y, L.ActQuant("int8mxu"), nonneg)
        assert torch.equal(int8mxu.quantize_act(y.clamp(min=0) if nonneg else y, 6.0, nonneg),
                           want)


def _int8s_apart(case):
    want = _reference(case)
    for mode in ("int8s", "none"):
        gaps = _gaps(_port(case, mode), want, case[3])
        assert gaps["depth"] > 2 * DEPTH_MEAN_PLANES and gaps["confidence"] > 2 * CONF_MEAN, \
            (mode, gaps)


CASES = {"forward": _forward, "act_quant_range": _range, "sites": _sites,
         "operand_hand_cases": _operand_hand_cases, "link_hand_cases": _link_hand_cases,
         "int8s_and_none_apart": _int8s_apart}


@pytest.mark.parametrize("name", list(CASES))
def test_the_port_against_the_int8mxu_reference(case, name):
    CASES[name](case)
