"""The A-TVSNet forward under act_quant="int8mxu", in plain PyTorch: the yardstick of the
int8 volume path.

The network is reference.model's, whose leaves (convolutions, batch norms, transposed
convolutions, the geometry, the soft-argmins) are imported unchanged; this file composes
the four functions that the mode changes again, `crm`, `refine_net` (with `refinement`,
which calls it), `aggregate` / `aggregate_output` and `forward`, with two additions that
follow the JAX package's definition of the mode:

  * every volume link round-trips through the static int8 lattice
    (atvsnet_tpu/nn/layers.py:341 `_maybe_quant_act`, mode int8s): a relu link at
    range / 255 onto [0, 255], a signed link at range / 127 onto [-127, 127];
  * every conv that the JAX package marks `qin` runs on int8 operands
    (atvsnet_tpu/nn/layers.py:190 `_quant_conv_operands`, used at :233): x onto the signed
    lattice at si = range / 127, w per tensor at sw = max|w| / 127 + 1e-12, both rounded
    half to even and clipped to [-127, 127]. The integer conv is computed in float64, which
    is exact at these sums (27 * 64 * 127^2 < 2^53), rounded to float32 and scaled by
    si * sw in float32.

The sites, one by one (file and line of the JAX package):

  links, each a relu link:
    - every conv_bn and deconv_bn output (layers.py:398-410, :514-524): CRM's 19 trunk convs
      and 9 transposed convs (crm.py:80-83, :85-86), the refinement's 7 trunk convs, its
      two float entries `_prob_3dconv` and `_vishull_3dconv` and 3 transposed convs
      (refine.py:69-75, :108-109);
    - CRM's two mixed entry convs (crm.py:92-100) and the refinement's photo and geo
      entries (refine.py:79-81 through conv3d_mixed_bn, layers.py:671-683; :96-100);
  qin convs (int8 operands):
    - CRM: the 19 trunk convs (crm.py:80, qin=True by default) and the prob conv
      `conv_b2_6_2` (crm.py:145);
    - refinement: the 7 trunk convs (refine.py:69) and `d_cost_vol` (refine.py:124);
    - AAM: the [unique | shared] conv with its relu (aam.py:81) and the output conv
      (aam.py:125);
  float convs: CRM's two mixed entries (no qin, crm.py:92-100), the refinement's four
  entries (refine.py:79-81, :96, :108-109), the transposed convs, the FEM and everything
  2D.

Departures: none in the mathematics. The JAX package computes the int8 conv with int32
sums and this file with float64 sums of the same integers, which are the same numbers; the
scalars are float32 tensors and the divisions element by element, as the port computes
them. Float convolutions run with TF32 off (set on entry, restored on return); `tf32=True`
allows it, the precision below the float32 the configurations state (the check's control).
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M


def _scalar(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def quantize_act(y, act_range: float, nonneg: bool = True):
    """The int8s round trip of a volume link: relu links (nonneg) at range / 255 onto
    [0, 255], signed ones at range / 127 onto [-127, 127]."""
    s = _scalar(act_range / (255.0 if nonneg else 127.0), y.device)
    lo, hi = (0.0, 255.0) if nonneg else (-127.0, 127.0)
    return torch.clamp(torch.round(y / s), lo, hi) * s


def quant_operands(x, w, act_range: float):
    """(xq, wq, si * sw): the integer values (as float32) of a qin conv's operands and the
    scale that turns their sums back into x's."""
    si = _scalar(act_range / 127.0, x.device)
    xq = torch.clamp(torch.round(x / si), -127.0, 127.0)
    sw = w.abs().amax() / _scalar(127.0, w.device) + 1e-12
    wq = torch.clamp(torch.round(w / sw), -127.0, 127.0)
    return xq, wq, si * sw


def qconv(x, w, act_range: float, stride: int = 1, act: bool = False):
    """A qin conv: TF-SAME, 3x3x3, no bias, on int8 operands; the integer sums in float64."""
    if x.ndim != 5 or tuple(w.shape[2:]) != (3, 3, 3) or stride not in (1, 2):
        raise ValueError(f"a qin conv is a 3x3x3 volume conv at stride 1 or 2; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, stride {stride}")
    xq, wq, scale = quant_operands(x, w, act_range)
    pads = [M.same_pads(s, 3, stride) for s in x.shape[1:-1]]
    acc = M._padded_conv(xq.double(), wq.double(), None, stride, 1, pads)
    y = acc.float() * scale
    return M.relu(y) if act else y


def crm(p, warped, ref2d, act_range: float, eps=1e-3):
    """reference.model.crm under int8mxu (atvsnet_tpu/nn/crm.py:76-145)."""

    def cbn(name, x, stride=1):
        y = M.batch_norm(qconv(x, p[f"crm/{name}/w"], act_range, stride), eps)
        return quantize_act(M.relu(y), act_range)

    def dbn(name, x):
        return quantize_act(M.deconv_bn(x, p[f"crm/{name}/w"], eps), act_range)

    Cc = ref2d.shape[-1]

    def mixed(name, stride):
        w = p[f"crm/{name}/w"]
        return quantize_act(M.conv3d_mixed_bn(torch.cat([w[:, Cc:], w[:, :Cc]], dim=1),
                                              warped, ref2d, stride, eps), act_range)

    b0_1_0 = mixed("conv_b0_1_0", 2)
    b0_0_1 = mixed("conv_b0_0_1", 1)
    b0_2_0 = cbn("conv_b0_2_0", b0_1_0, 2)
    b0_3_0 = cbn("conv_b0_3_0", b0_2_0, 2)
    b0_1_1 = cbn("conv_b0_1_1", b0_1_0)
    b0_2_1 = cbn("conv_b0_2_1", b0_2_0)
    b0_3_1 = cbn("conv_b0_3_1", b0_3_0)
    b0_4_0 = dbn("conv_b0_4_0", b0_3_1)
    b0_5_0 = dbn("conv_b0_5_0", b0_4_0 + b0_2_1)
    b0_6_0 = dbn("conv_b0_6_0", b0_5_0 + b0_1_1)

    b1_0_0 = b0_6_0 + b0_0_1
    b1_1_0 = cbn("conv_b1_1_0", b1_0_0, 2)
    b1_2_0 = cbn("conv_b1_2_0", b1_1_0, 2)
    b1_3_0 = cbn("conv_b1_3_0", b1_2_0, 2)
    b1_0_1 = cbn("conv_b1_0_1", b1_0_0)
    b1_1_1 = cbn("conv_b1_1_1", b1_1_0 + b0_5_0)
    b1_2_1 = cbn("conv_b1_2_1", b1_2_0 + b0_4_0)
    b1_3_1 = cbn("conv_b1_3_1", b1_3_0)
    b1_4_0 = dbn("conv_b1_4_0", b1_3_1)
    b1_5_0 = dbn("conv_b1_5_0", b1_4_0 + b1_2_1 + b0_2_1)
    b1_6_0 = dbn("conv_b1_6_0", b1_5_0 + b1_1_1 + b0_1_1)

    b2_0_0 = b1_6_0 + b1_0_1
    b2_1_0 = cbn("conv_b2_1_0", b2_0_0, 2)
    b2_2_0 = cbn("conv_b2_2_0", b2_1_0, 2)
    b2_3_0 = cbn("conv_b2_3_0", b2_2_0, 2)
    b2_0_1 = cbn("conv_b2_0_1", b2_0_0)
    b2_1_1 = cbn("conv_b2_1_1", b2_1_0 + b1_5_0)
    b2_2_1 = cbn("conv_b2_2_1", b2_2_0 + b1_4_0)
    b2_3_1 = cbn("conv_b2_3_1", b2_3_0)
    b2_4_0 = dbn("conv_b2_4_0", b2_3_1)
    b2_5_0 = dbn("conv_b2_5_0", b2_4_0 + b2_2_1 + b0_2_1)
    b2_6_0 = dbn("conv_b2_6_0", b2_5_0 + b2_1_1 + b0_1_1)
    filtered = b2_6_0 + b2_0_1
    return filtered, qconv(filtered, p["crm/conv_b2_6_2/w"], act_range)[..., 0]


def refine_net(p, photo, geo, prob_vol, vis_hull, act_range: float, eps=1e-3):
    """reference.model.refine_net under int8mxu (atvsnet_tpu/nn/refine.py:65-125): the four
    entries float, their links and the trunk's quantized, the trunk and d_cost_vol qin."""

    def w(name):
        return p[f"refine/global_refine{name}/w"]

    def cbn(name, x, stride=1):
        y = M.batch_norm(qconv(x, w(name), act_range, stride), eps)
        return quantize_act(M.relu(y), act_range)

    def entry(name, x):
        return quantize_act(M.conv_bn(x, w(name), eps=eps), act_range)

    def dbn(name, x):
        return quantize_act(M.deconv_bn(x, w(name), eps), act_range)

    ph = quantize_act(M.conv3d_mixed_bn(w("_photo_3dconv"), photo[0], photo[1], eps=eps),
                      act_range)
    vary, const2d, nf = geo
    wg = w("_geo_3dconv")
    wg = torch.cat([wg[:, 0:1], wg[:, 1:1 + nf].sum(dim=1, keepdim=True), wg[:, 1 + nf:]], dim=1)
    ge = quantize_act(M.conv3d_mixed_bn(wg, vary, const2d, eps=eps), act_range)
    x = torch.cat([ph, ge, entry("_prob_3dconv", prob_vol), entry("_vishull_3dconv", vis_hull)],
                  dim=-1)
    c1_0 = cbn("_3dconv1_0", x, 2)
    c2_0 = cbn("_3dconv2_0", c1_0, 2)
    c3_0 = cbn("_3dconv3_0", c2_0, 2)
    c0_1 = cbn("_3dconv0_1", x)
    c1_1 = cbn("_3dconv1_1", c1_0)
    c2_1 = cbn("_3dconv2_1", c2_0)
    c3_1 = cbn("_3dconv3_1", c3_0)
    c4_0 = dbn("_3dconv4_0", c3_1)
    c5_0 = dbn("_3dconv5_0", c4_0 + c2_1)
    c6_0 = dbn("_3dconv6_0", c5_0 + c1_1)
    c6_1 = c6_0 + c0_1
    return c6_1, qconv(c6_1, p["refine/global_refined_cost_vol/w"], act_range)[..., 0]


def aggregate(p, stage, x, act_range: float):
    """reference.model.aggregate with the [unique | shared] conv qin
    (atvsnet_tpu/nn/aam.py:68-90)."""
    a = f"aam{stage}_att"
    P, B, C = x.shape[0], x.shape[1], x.shape[-1]
    w = torch.cat([p[f"{a}/weight_unique"], p[f"{a}/weight_shared"]], dim=0)
    both = qconv(x.reshape((P * B,) + x.shape[2:]), w, act_range, act=True)
    both = both.reshape(x.shape[:-1] + (2 * C,))
    unique, shared = both[..., :C], both[..., C:]
    score = torch.softmax(unique - shared + shared.sum(dim=0, keepdim=True), dim=0)
    return torch.sum(score * x, dim=0)


def aggregate_output(p, stage, x, act_range: float):
    """reference.model.aggregate_output, qin (atvsnet_tpu/nn/aam.py:120-125)."""
    name = "aam1_out/attention_prob_vol" if stage == 1 else "aam2_out/attention_prob_vol_refine"
    return qconv(x, p[f"{name}/w"], act_range)[..., 0]


def refinement(p, depth_ref, depth_view, ref_cam, view_cam, shallow_ref, shallow_view,
               prob_vol, start, interval, act_range: float, eps=1e-3):
    """reference.model.refinement, line for line, into this file's refine_net."""
    D = prob_vol.shape[1]
    nf = shallow_ref.shape[-1]
    dvt = M.transform_depth(depth_view, view_cam, ref_cam)
    hom = M.homographies(ref_cam, view_cam, D, start, interval)
    warped, near, mask = M.sweep_warp_with_nearest(torch.cat([shallow_view, dvt], dim=-1), hom,
                                                   slice(nf, nf + 1))
    photo_vol = (warped[..., :nf] - shallow_ref[:, None]).abs() * mask.float()
    sweep = M.sweep_values(start, interval, D)[:, :, None, None, None]
    denom = (interval * D)[:, None, None, None, None]
    geo_ref = (depth_ref[:, None] - sweep).abs() / denom
    geo_view = (warped[..., nf:] - sweep).abs() / denom * mask.float()
    warped_f, mask_p = M.warp_by_depth(shallow_view, ref_cam, view_cam, depth_ref)
    photo_err = (warped_f - shallow_ref).abs() * mask_p.float()
    warped_d, mask_g = M.warp_by_depth(dvt, ref_cam, view_cam, depth_ref, nearest=True)
    geo_err = (warped_d - depth_ref).abs() * mask_g.float()
    sweep_hw = sweep[..., 0]

    def free_space(d):
        return ((d > 0) & (d > sweep_hw)).float()

    hull = (free_space(depth_ref[..., 0][:, None]) + free_space(near[..., 0])) / 2.0
    return refine_net(p, (photo_vol, torch.cat([photo_err, shallow_ref], dim=-1)),
                      (torch.cat([geo_ref, geo_view], dim=-1),
                       torch.cat([geo_err, depth_ref], dim=-1), nf),
                      prob_vol[..., None], hull[..., None], act_range, eps)


@torch.no_grad()
def forward(p, images, cams, D, act_range: float = 6.0, upsample=True, eps=1e-3,
            tf32: bool = False):
    """reference.model.forward under int8mxu at `act_range` (PipelineConfig.act_quant_range):
    the same inputs and outputs. The float convs run with TF32 off, or on with tf32=True."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        N = images.shape[1]
        start, interval = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
        feats = M.features(p, images, eps=eps)
        shallow = M.features(p, images, shallow=True, eps=eps)
        ref_f, ref_cam = feats[:, 0], cams[:, 0]

        costs, views = [], []
        for i in range(1, N):
            hom = M.homographies(ref_cam, cams[:, i], D, start, interval)
            filtered, _ = crm(p, M.sweep_warp(feats[:, i], hom), ref_f, act_range, eps)
            hom_v = M.homographies(cams[:, i], ref_cam, D, start, interval)
            _, prob_v = crm(p, M.sweep_warp(ref_f, hom_v), feats[:, i], act_range, eps)
            costs.append(filtered)
            views.append(M.softargmin(prob_v, start, interval))
        cost_agg = aggregate(p, 1, torch.stack(costs), act_range)
        del costs
        prob_agg = aggregate_output(p, 1, cost_agg, act_range)
        depth_agg, _ = M.softargmin(prob_agg, start, interval, True)

        refined = []
        for i in range(1, N):
            cost_res, _ = refinement(p, depth_agg, views[i - 1], ref_cam, cams[:, i],
                                     shallow[:, 0], shallow[:, i], prob_agg, start, interval,
                                     act_range, eps)
            refined.append(cost_agg + cost_res)
        final = aggregate_output(p, 2, aggregate(p, 2, torch.stack(refined), act_range),
                                 act_range)
        depth, conf = M.softargmin(final, start, interval, True)
        out = {"depth": depth, "confidence": conf}
        if upsample:
            out["depth_up"], out["confidence_up"] = M.softargmin_upsampled(final, start,
                                                                           interval)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
