"""The A-TVSNet forward in the JAX package's speed mode, in plain PyTorch: compute_dtype
"bfloat16" with act_quant="int8s" and warp_quant="int8" (bench.py's defaults), the
yardstick of the cell serve5.bf16_int8s.

The network is reference.model's. Its conv, transposed-conv, norm, pooling, resize and
sampling leaves are replaced, for the body of `bf16_leaves`, by the mode's arithmetic below;
everything else of reference.model (the stage functions that only compose leaves, the
geometry, the soft-argmins) is used unchanged. The functions that the mode changes in more
than their leaves, `crm`, `refine_net`, `aggregate`, `refinement` and `forward`, are
composed again here, with the two lattices. The JAX package's definition, site by site
(atvsnet_tpu/nn/layers.py unless named):

  * activations are carried in bf16: the centred images are cast at the FEM's entry
    (atvsnet_tpu/models/tvsnet.py:67), and every elementwise op between leaves (skip adds,
    relus, the photometric volume's differences and mask products) is a bf16 op;
  * every conv and transposed-conv leaf multiplies bf16 operands exactly, sums in fp32 and
    rounds once to bf16 (`_conv2d` :57-70, `conv` :209-255, `fixed_pad_conv` :258-284,
    `deconv` :482-513, `conv3d_mixed` :627-668): here an fp32 conv of the bf16 values (a
    product of two bf16 values is exact in fp32; TF32 off, set on entry and restored on
    return), then one rounding. The weights are held in fp32 and cast to bf16 at the leaf
    (`w.astype(x.dtype)`, :63, :249), after the fp32 sums of conv3d_mixed's depth taps
    (:655-666) and of the geo entry's F identical in-channels (atvsnet_tpu/nn/refine.py:86-96);
  * a bias is added in bf16 to the rounded conv (:254, :283);
  * a batch norm takes fp32 statistics, E[x^2] - mean^2, and normalizes in bf16:
    (x - bf16(mean)) * bf16(rsqrt(var + eps)), then + bf16(beta) (:287-338);
  * an average pool sums in fp32 and returns bf16 (:527-558); the SPP's align-corners
    resize runs in fp32 at HIGHEST and returns bf16 (atvsnet_tpu/geometry/
    depth_regression.py:40-55); max pools compare bf16 values;
  * every volume link (each conv_bn, deconv_bn and conv3d_mixed_bn output of CRM and the
    refinement, all relu links) goes through the int8s round trip at range / 255 onto
    [0, 255], in fp32, back to bf16 (`_maybe_quant_act` :341-395; int8mxu.quantize_act);
  * every bilinear sample weights its four corners in bf16: the weights are computed in
    fp32, rounded to bf16, and the four products and their sum are bf16 ops, left to right
    (atvsnet_tpu/geometry/warp.py:120-146, :316-323);
  * every bilinear plane-sweep volume of CRM's sweeps goes through the per-(sample,
    channel) int8 lattice, s = max|image| / 127 + 1e-12 over the source map, in fp32, back
    to bf16 (geometry/warp.py:181-207 `_maybe_quant_warp`, called from plane_sweep_warp's
    bilinear branch only, :242, :248); the refinement's fused sweep is not quantized;
  * the refinement's view depth is rounded to bf16 before it is swept beside the shallow
    features, and read back as fp32 (atvsnet_tpu/models/tvsnet.py:202-213); the geometric
    terms and the visual hull are fp32 and cast to bf16 at the refine net's entry (:261-279);
  * AAM: the [unique | shared] conv with its relu in bf16, the sum over pairs in fp32
    rounded to bf16, the activation (unique - shared) + that sum in bf16, the softmax over
    pairs in fp32, bf16(score) * x in bf16, summed over pairs in fp32 and rounded
    (atvsnet_tpu/nn/aam.py:68-90; jnp.sum upcasts bf16 to fp32);
  * geometry (homographies, projections, coordinates, transform_depth), the soft-argmins
    and confidences (atvsnet_tpu/geometry/depth_regression.py:129, :169) and the
    norm statistics stay fp32.

Departures from the JAX package, listed:

  * the JAX package runs a 3D conv at stride 2, and at stride 1 outside its input-stacked
    class (Ci <= 16 on maps of at least 24000 pixels, layers.py:237-240), as one 2D conv
    with the three depth taps stacked on its output axis (layers.py:73-135): each tap's
    partial sum rounds to bf16 and the three add in bf16. Here, as in the port, every 3D
    conv rounds once. Its transposed convs (the vjp of the tap-stacked conv) accumulate
    all taps in one conv and round once, as here;
  * the fp32 sums run in aten's order here, in cuDNN's on the tensor cores in the port and
    in the MXU's in the JAX package. fp32 noise that crosses a bf16 rounding tie, or a
    lattice boundary of a link, moves a value by one step, and the step cascades through
    the U-Nets: the sound runs' gaps (PERF.md section 2);
  * the port's bf16 conv with a bias adds it inside the conv (aten's bias argument), before
    the one rounding; here and in the JAX package it is added after. Only the bottleneck
    convs of the FEM and the shallow FEM carry a bias.

`bits` (8, bf16's significant bits) sets the precision of the explicit roundings: the
image cast, the weights at each leaf, the leaves' outputs and biases, the norms' outputs
and statistics, the pools, the resize, the corner weights, the AAM's sums and scores, the
lattices' dequantized values and the geometric terms at the refine net's entry. bits < 8 is the check's control
(a): those values keep fewer bits, while the bf16 ops between them round as before.
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M
from benchmark.reference.int8mxu import quantize_act

BF16 = torch.bfloat16
F32 = torch.float32
_AVG_POOL = M.avg_pool_same
_RESIZE = M.resize_align_corners


def round_bits(t: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """t (any float dtype) rounded to `bits` significant bits (1 to 8), to nearest, ties to
    even, as a bf16 tensor (exact: bf16 keeps 8); bits=8 is the cast to bf16. Finite values
    only; a value past bf16's largest rounds to inf."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be 1 to 8, got {bits}")
    if bits == 8:
        return t.to(BF16)
    drop = 24 - bits
    i = t.to(F32).view(torch.int32)
    i = i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)
    return (i & ~((1 << drop) - 1)).view(F32).to(BF16)


class _Mode:
    """The mode's rounding while the leaves are swapped in (bf16_leaves sets `bits`)."""

    bits = 8


def rnd(t: torch.Tensor) -> torch.Tensor:
    """The mode's rounding to bf16 of a float value (at _Mode.bits significant bits)."""
    return round_bits(t.to(F32), _Mode.bits)


def _leaf(fn):
    """A conv or transposed-conv leaf of reference.model in the mode: bf16 operands, the
    products exact and summed in fp32 (TF32 off), one rounding, then the bias in bf16."""
    def leaf(x, w, b=None, **kw):
        if x.dtype != BF16:
            raise TypeError(f"a bf16 leaf takes the bf16 activations the mode carries, got "
                            f"{x.dtype}")
        y = rnd(fn(x.to(F32), rnd(w).to(F32), None, **kw))      # channel-first
        if b is None:
            return y
        return rnd(y.to(F32) + rnd(b).to(F32).reshape((-1,) + (1,) * (y.ndim - 2)))

    return leaf


def batch_norm(x, eps=1e-3, beta=None):
    """reference.model.batch_norm in the mode: fp32 statistics, the normalization in bf16."""
    axes = tuple(range(1, x.ndim - 1))
    xf = x.to(F32)
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.square().mean(dim=axes, keepdim=True) - mean.square()
    y = rnd((x - rnd(mean)) * rnd(torch.rsqrt(var + eps)))
    return y if beta is None else rnd(y + rnd(beta))


def avg_pool_same(x, pool, stride):
    """The fp32 average pool of the bf16 values, rounded to bf16."""
    return rnd(_AVG_POOL(x.to(F32), pool, stride))


def resize_align_corners(x, out_h, out_w):
    """The fp32 align-corners resize (TF32 off) of the bf16 values, rounded to bf16."""
    if (out_h, out_w) == tuple(x.shape[1:3]):
        return x
    return rnd(_RESIZE(x.to(F32), out_h, out_w))


def sample(image, x, y, bilinear=True, nearest=None):
    """reference.model.sample with the corner weights in the image's dtype: computed in
    fp32 and rounded, the four products and their sum in that dtype (bf16 here)."""
    B, H, W, C = image.shape
    x, y = x - 0.5, y - 0.5
    valid = (torch.isfinite(x) & torch.isfinite(y) & (x >= 0) & (y >= 0)
             & (x < W - 1) & (y < H - 1))
    x, y = torch.where(valid, x, 0.0), torch.where(valid, y, 0.0)
    flat = image.reshape(B * H * W, C)
    base = (torch.arange(B, device=image.device) * (H * W))[:, None]

    def gather(table, iy, ix):
        return table.index_select(0, (iy * W + ix + base).reshape(-1)).reshape(
            B, -1, table.shape[-1])

    near = None
    if nearest is not None:
        near = gather(flat[:, nearest], torch.round(y).long(), torch.round(x).long())
    if not bilinear:
        return None, near, valid
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.where(valid, x0 + 1, 0), torch.where(valid, y0 + 1, 0)
    x0, y0 = x0.clamp(0, W - 1), y0.clamp(0, H - 1)
    x0f, x1f, y0f, y1f = (v.to(F32) for v in (x0, x1, y0, y1))

    def weight(v):
        return (rnd(v) if image.dtype == BF16 else v.to(image.dtype))[..., None]

    wa = weight((y1f - y) * (x1f - x))
    wb = weight((y1f - y) * (x - x0f))
    wc = weight((y - y0f) * (x1f - x))
    wd = weight((y - y0f) * (x - x0f))
    x1, y1 = x1.clamp(max=W - 1), y1.clamp(max=H - 1)
    out = (wa * gather(flat, y0, x0) + wb * gather(flat, y0, x1)
           + wc * gather(flat, y1, x0) + wd * gather(flat, y1, x1))
    return out, near, valid


class bf16_leaves:
    """reference.model's leaves in the mode, at `bits` significant bits, with TF32 off, for
    the body of a `with`; the leaves, the bits and both TF32 flags read as before
    afterwards."""

    def __init__(self, bits: int = 8):
        self.bits = bits

    def __enter__(self):
        self.saved = (dict(M._CONV), dict(M._CONV_T), M.batch_norm, M.avg_pool_same,
                      M.resize_align_corners, M.sample, _Mode.bits)
        self.flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        M._CONV.update({nd: _leaf(f) for nd, f in self.saved[0].items()})
        M._CONV_T.update({nd: _leaf(f) for nd, f in self.saved[1].items()})
        M.batch_norm, M.avg_pool_same = batch_norm, avg_pool_same
        M.resize_align_corners, M.sample = resize_align_corners, sample
        _Mode.bits = self.bits

    def __exit__(self, *exc):
        M._CONV.update(self.saved[0])
        M._CONV_T.update(self.saved[1])
        (M.batch_norm, M.avg_pool_same, M.resize_align_corners, M.sample,
         _Mode.bits) = self.saved[2:]
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags
        return False


def link(y, act_range: float):
    """A relu volume link's int8s round trip: in fp32, back to bf16."""
    return rnd(quantize_act(y.to(F32), act_range))


def quantize_warp(out, image):
    """A bilinear sweep volume (B, D, H, W, C) of `image` (B, H, W, C) on its per-(sample,
    channel) int8 lattice: s = max|image| / 127 + 1e-12, in fp32, back to bf16."""
    divisor = torch.full((), 127.0, dtype=F32, device=image.device)
    s = (image.to(F32).abs().amax(dim=(1, 2), keepdim=True) / divisor + 1e-12)[:, None]
    return rnd(torch.clamp(torch.round(out.to(F32) / s), -127.0, 127.0) * s)


def crm(p, warped, ref2d, act_range: float, eps=1e-3):
    """reference.model.crm with its links on the int8s lattice (atvsnet_tpu/nn/crm.py:60-146)."""

    def cbn(name, x, stride=1):
        return link(M.conv_bn(x, p[f"crm/{name}/w"], stride=stride, eps=eps), act_range)

    def dbn(name, x):
        return link(M.deconv_bn(x, p[f"crm/{name}/w"], eps), act_range)

    Cc = ref2d.shape[-1]

    def mixed(name, stride):
        w = p[f"crm/{name}/w"]
        return link(M.conv3d_mixed_bn(torch.cat([w[:, Cc:], w[:, :Cc]], dim=1), warped, ref2d,
                                      stride, eps), act_range)

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
    return filtered, M.conv(filtered, p["crm/conv_b2_6_2/w"])[..., 0]


def refine_net(p, photo, geo, prob_vol, vis_hull, act_range: float, eps=1e-3):
    """reference.model.refine_net with its links on the int8s lattice
    (atvsnet_tpu/nn/refine.py:45-125)."""

    def w(name):
        return p[f"refine/global_refine{name}/w"]

    def cbn(name, x, stride=1):
        return link(M.conv_bn(x, w(name), stride=stride, eps=eps), act_range)

    def dbn(name, x):
        return link(M.deconv_bn(x, w(name), eps), act_range)

    ph = link(M.conv3d_mixed_bn(w("_photo_3dconv"), photo[0], photo[1], eps=eps), act_range)
    vary, const2d, nf = geo
    wg = w("_geo_3dconv")
    wg = torch.cat([wg[:, 0:1], wg[:, 1:1 + nf].sum(dim=1, keepdim=True), wg[:, 1 + nf:]], dim=1)
    ge = link(M.conv3d_mixed_bn(wg, vary, const2d, eps=eps), act_range)
    x = torch.cat([ph, ge, cbn("_prob_3dconv", prob_vol), cbn("_vishull_3dconv", vis_hull)],
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
    return c6_1, M.conv(c6_1, p["refine/global_refined_cost_vol/w"])[..., 0]


def aggregate(p, stage, x):
    """reference.model.aggregate in the mode (atvsnet_tpu/nn/aam.py:68-90)."""
    a = f"aam{stage}_att"
    P, B, C = x.shape[0], x.shape[1], x.shape[-1]
    w = torch.cat([p[f"{a}/weight_unique"], p[f"{a}/weight_shared"]], dim=0)
    both = M.conv(x.reshape((P * B,) + x.shape[2:]), w, act=True).reshape(x.shape[:-1] + (2 * C,))
    unique, shared = both[..., :C], both[..., C:]
    act = unique - shared + rnd(shared.to(F32).sum(dim=0, keepdim=True))
    score = torch.softmax(act.to(F32), dim=0)
    return rnd((rnd(score) * x).to(F32).sum(dim=0))


def refinement(p, depth_ref, depth_view, ref_cam, view_cam, shallow_ref, shallow_view,
               prob_vol, start, interval, act_range: float, eps=1e-3):
    """reference.model.refinement in the mode (atvsnet_tpu/models/tvsnet.py:163-279)."""
    D = prob_vol.shape[1]
    nf = shallow_ref.shape[-1]
    dvt = M.transform_depth(depth_view, view_cam, ref_cam)
    hom = M.homographies(ref_cam, view_cam, D, start, interval)
    warped, near, mask = M.sweep_warp_with_nearest(torch.cat([shallow_view, rnd(dvt)], dim=-1),
                                                   hom, slice(nf, nf + 1))
    photo_vol = (warped[..., :nf] - shallow_ref[:, None]).abs() * mask.to(BF16)
    sweep = M.sweep_values(start, interval, D)[:, :, None, None, None]
    denom = (interval * D)[:, None, None, None, None]
    geo_ref = (depth_ref[:, None] - sweep).abs() / denom
    geo_view = (warped[..., nf:].to(F32) - sweep).abs() / denom * mask.to(F32)
    warped_f, mask_p = M.warp_by_depth(shallow_view, ref_cam, view_cam, depth_ref)
    photo_err = (warped_f - shallow_ref).abs() * mask_p.to(BF16)
    warped_d, mask_g = M.warp_by_depth(dvt, ref_cam, view_cam, depth_ref, nearest=True)
    geo_err = (warped_d - depth_ref).abs() * mask_g.to(F32)
    sweep_hw = sweep[..., 0]

    def free_space(d):
        return ((d > 0) & (d > sweep_hw)).to(F32)

    hull = (free_space(depth_ref[..., 0][:, None]) + free_space(near[..., 0].to(F32))) / 2.0
    return refine_net(p, (photo_vol, torch.cat([photo_err, shallow_ref], dim=-1)),
                      (rnd(torch.cat([geo_ref, geo_view], dim=-1)),
                       rnd(torch.cat([geo_err, depth_ref], dim=-1)), nf),
                      prob_vol[..., None], rnd(hull[..., None]), act_range, eps)


def sweep_warp(image, hom):
    """A CRM plane sweep in the mode: the bf16 bilinear volume on the warp lattice."""
    return quantize_warp(M.sweep_warp(image, hom), image)


@torch.no_grad()
def forward(p, images, cams, D, act_range: float = 6.0, upsample=True, eps=1e-3,
            bits: int = 8):
    """reference.model.forward in the mode, the links at `act_range`
    (PipelineConfig.act_quant_range): the same inputs and outputs, fp32 maps. bits < 8 is
    the check's control (see the module)."""
    with bf16_leaves(bits):
        N = images.shape[1]
        start, interval = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
        images = rnd(images)
        feats = M.features(p, images, eps=eps)
        shallow = M.features(p, images, shallow=True, eps=eps)
        ref_f, ref_cam = feats[:, 0], cams[:, 0]

        costs, views = [], []
        for i in range(1, N):
            hom = M.homographies(ref_cam, cams[:, i], D, start, interval)
            filtered, _ = crm(p, sweep_warp(feats[:, i], hom), ref_f, act_range, eps)
            hom_v = M.homographies(cams[:, i], ref_cam, D, start, interval)
            _, prob_v = crm(p, sweep_warp(ref_f, hom_v), feats[:, i], act_range, eps)
            costs.append(filtered)
            views.append(M.softargmin(prob_v.to(F32), start, interval))
        cost_agg = aggregate(p, 1, torch.stack(costs))
        del costs
        prob_agg = M.aggregate_output(p, 1, cost_agg)
        depth_agg, _ = M.softargmin(prob_agg.to(F32), start, interval, True)

        refined = []
        for i in range(1, N):
            cost_res, _ = refinement(p, depth_agg, views[i - 1], ref_cam, cams[:, i],
                                     shallow[:, 0], shallow[:, i], prob_agg, start, interval,
                                     act_range, eps)
            refined.append(cost_agg + cost_res)
        final = M.aggregate_output(p, 2, aggregate(p, 2, torch.stack(refined))).to(F32)
        depth, conf = M.softargmin(final, start, interval, True)
        out = {"depth": depth, "confidence": conf}
        if upsample:
            out["depth_up"], out["confidence_up"] = M.softargmin_upsampled(final, start,
                                                                           interval)
        return out
