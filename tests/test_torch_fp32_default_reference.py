"""fp32_precision="default" in the port against the plain one-pass reference of the
benchmark (benchmark/reference/fp32_default.py), on the CPU: the reference that decides
`correct` in the cell serve5.full_tf32passes.

One test, in cases: the port's forward at "default" against the reference on seeded random
weights at 3 views, 64x96, D=16, depth and confidence, at the cost volume's resolution and
upsampled; the port at "highest" (the rounding left out) told apart from it at that size;
the conv and transposed-conv leaves of both, call by call, with the same operand shapes;
and the reference's rounding and its scope on hand cases. This file imports no JAX.
"""

import pytest
import torch

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models.atvsnet import center_images, multi_view_forward
from atvsnet_torch.nn import layers as L
from atvsnet_torch.params import init_model
from benchmark import scenes
from benchmark.reference import fp32_default
from benchmark.reference import model as ref_model
from benchmark.reference import preprocess

VIEWS, H, W, D = 3, 64, 96, 16
OUTPUTS = ("depth", "confidence", "depth_up", "confidence_up")
# Tolerances of the forward's mean gaps, in planes of the sweep for depth and as they are
# for confidence. On the CPU the port's pass leaves and the reference's leaves run aten's
# float32 convolution on the same bf16-rounded operands, and read 0 over 4 cases of random
# weights and scenes. Another summation order (a thread count, another oneDNN algorithm)
# moves a leaf's output by fp32 noise, and where that crosses a bf16 rounding tie the next
# leaf's operand moves by a bf16 step, which the U-Nets carry on: the limits leave room for
# that. The port at "highest" reads 0.052-0.086 planes and 0.0117-0.0149 in confidence
# against the reference at this size (the same 4 cases), 5x the limits and more.
DEPTH_MEAN_PLANES = 0.01
CONF_MEAN = 0.002


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(2)
    rig = scenes.render_rig(VIEWS, H, W, 11)
    prep = preprocess.prepare(list(scenes.frames_uint8(rig)), list(scenes.rig_cams(rig, 128)),
                              VIEWS, max_d=D, max_h=H, max_w=W)
    model = init_model(PipelineConfig(view_num=VIEWS, max_d=D, max_h=H, max_w=W), 3, "cpu")
    weights = {n.replace(".", "/"): t.detach() for n, t in model.named_parameters()}
    return model, weights, torch.from_numpy(prep["images"]), prep["cams"]


def _port(case, mode):
    model, _, images, cams = case
    cfg = PipelineConfig(view_num=VIEWS, max_d=D, max_h=H, max_w=W, fp32_precision=mode)
    return multi_view_forward(model, center_images(images), cams, cfg, out_prob_map=True)


def _reference(case):
    _, weights, images, cams = case
    return fp32_default.forward(weights, ref_model.center_images(images),
                                torch.from_numpy(cams), D)


def _gaps(got, want, cams):
    """{output: mean gap}, depths in planes."""
    interval = float(cams[0, 0, 1, 3, 1])
    return {k: ((got[k] - want[k]).abs().mean() / (interval if k.startswith("depth") else 1.0))
            .item() for k in OUTPUTS}


def _limit(k):
    return DEPTH_MEAN_PLANES if k.startswith("depth") else CONF_MEAN


def _forward(case):
    for k, gap in _gaps(_port(case, "default"), _reference(case), case[3]).items():
        assert gap < _limit(k), (k, gap)


def _highest_apart(case):
    gaps = _gaps(_port(case, "highest"), _reference(case), case[3])
    for k in ("depth", "confidence"):
        assert gaps[k] > 3 * _limit(k), gaps


def _sites(case):
    """The port's pass leaves and the reference's conv leaves: as many calls, with the
    same operand shapes, in each kind."""
    port = {"conv": [], "conv_transpose": []}
    ref = {"conv": [], "conv_transpose": []}

    def logged(calls, kind, leaf):
        def wrapped(x, w, *args, **kw):
            calls[kind].append((tuple(x.shape), tuple(w.shape)))
            return leaf(x, w, *args, **kw)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "pass_conv", logged(port, "conv", L.pass_conv))
        mp.setattr(L, "pass_conv_transpose", logged(port, "conv_transpose",
                                                    L.pass_conv_transpose))
        for nd in (2, 3):
            mp.setitem(ref_model._CONV, nd, logged(ref, "conv", ref_model._CONV[nd]))
            mp.setitem(ref_model._CONV_T, nd, logged(ref, "conv_transpose",
                                                     ref_model._CONV_T[nd]))
        _port(case, "default")
        _reference(case)
    # 2 pairs x 2 directions of CRM with 9 transposed convs each, 2 refinements with 3
    assert len(port["conv_transpose"]) == 4 * 9 + 2 * 3
    assert sorted(port["conv"]) == sorted(ref["conv"])
    assert port["conv_transpose"] == ref["conv_transpose"]


def _rounding_hand_cases(case):
    # bf16 keeps 8 significant bits: 1 + 2^-8 is a tie between 1 and 1 + 2^-7 and goes to
    # the even 1; 1 + 3 * 2^-8 goes to the even 1 + 2^-6; 1 + 2^-8 + 2^-20 rounds up
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20, -3.0, 0.0])
    assert fp32_default.bf16_round(x).tolist() == [1.0, 1 + 2 ** -6, 1 + 2 ** -7, -3.0, 0.0]
    # the leaves round both operands, and only inside the scope
    xs = torch.full((1, 1, 1, 1), 1 + 2 ** -8)
    ws = torch.full((1, 1, 1, 1), 1 + 3 * 2 ** -8)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with fp32_default.one_pass_leaves():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert ref_model._CONV[2](xs, ws).item() == 1 + 2 ** -6
        assert ref_model._CONV_T[2](xs, ws).item() == 1 + 2 ** -6
    assert ref_model._CONV[2](xs, ws).item() == (1 + 2 ** -8) * (1 + 3 * 2 ** -8)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


CASES = {"forward": _forward, "highest_apart": _highest_apart, "sites": _sites,
         "rounding_hand_cases": _rounding_hand_cases}


@pytest.mark.parametrize("name", list(CASES))
def test_the_port_against_the_one_pass_reference(case, name):
    CASES[name](case)
