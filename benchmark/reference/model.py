"""The A-TVSNet forward in plain PyTorch, frozen: the yardstick that the served and
written depth maps are held to.

One function per stage, in the order of the published network (Dai et al., A-TVSNet,
arXiv:2003.00711; the reference code daiszh/A-TVSNet, cnn_wrapper/atvsnet.py and
atvsnet/model.py): feature extraction (a dilated ResNet with spatial pyramid pooling, and
a shallow one for the refinement), per pair a plane-sweep cost volume through the
stacked 3D U-Net in both directions, attention aggregation over the pairs, per pair the
geometry-aware refinement, a second aggregation, and the soft-argmin with its 4-bin
confidence, at the cost volume's resolution and 4x upsampled.

Inference only, float32 throughout, batch statistics per sample, TF-SAME padding.
Activations are channel-last; each convolution runs on a channel-first view of the same
memory. No kernel of the program, no quantization, no mesh: every convolution is one
aten convolution, every soft-argmin the softmax formula. Weights come as a dict of
tensors in PyTorch's layouts (reference.weights.load_weights).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
_SPP_POOLS = (64, 32, 16, 8)
_ZERO = torch.zeros(())


def relu(y):
    return torch.maximum(y, _ZERO)


def same_pads(n: int, k: int, stride: int, rate: int = 1):
    """TF 'SAME' padding (begin, end) of one axis."""
    k_eff = k + (k - 1) * (rate - 1)
    out = -(-n // stride)
    total = max((out - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def _padded_conv(x, w, b, stride, rate, pads):
    xc = x.movedim(-1, 1)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, [p for lo, hi in reversed(pads) for p in (lo, hi)])
        padding = 0
    return _CONV[x.ndim - 2](xc, w, b, stride=stride, padding=padding,
                             dilation=rate).movedim(1, -1)


def conv(x, w, b=None, stride=1, rate=1, act=False):
    pads = [same_pads(s, k, stride, rate) for s, k in zip(x.shape[1:-1], w.shape[2:])]
    y = _padded_conv(x, w, b, stride, rate, pads)
    return relu(y) if act else y


def fixed_pad_conv(x, w, b, stride, rate=1, act=False):
    k = w.shape[2]
    total = k + (k - 1) * (rate - 1) - 1
    y = _padded_conv(x, w, b, stride, rate, [(total // 2, total - total // 2)] * (x.ndim - 2))
    return relu(y) if act else y


def batch_norm(x, eps=1e-3, beta=None):
    axes = tuple(range(1, x.ndim - 1))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.square().mean(dim=axes, keepdim=True) - mean.square()
    y = (x - mean) * torch.rsqrt(var + eps)
    return y if beta is None else y + beta


def conv_bn(x, w, stride=1, rate=1, eps=1e-3, act=True):
    y = batch_norm(conv(x, w, stride=stride, rate=rate), eps)
    return relu(y) if act else y


def deconv(x, w, stride=2):
    """TF conv_transpose SAME; w is (in, out, k...)."""
    outs = [s * stride for s in x.shape[1:-1]]
    begs = [same_pads(o, k, stride)[0] for o, k in zip(outs, w.shape[2:])]
    y = _CONV_T[x.ndim - 2](x.movedim(-1, 1), w, stride=stride)
    y = y[(slice(None), slice(None)) + tuple(slice(b, b + o) for b, o in zip(begs, outs))]
    return y.movedim(1, -1)


def deconv_bn(x, w, eps=1e-3):
    return relu(batch_norm(deconv(x, w), eps))


def avg_pool_same(x, pool, stride):
    pads = [same_pads(s, pool, stride) for s in x.shape[1:-1]]
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    fn = {2: F.avg_pool2d, 3: F.avg_pool3d}[x.ndim - 2]

    def window_sum(t):
        return fn(F.pad(t, flat), pool, stride, divisor_override=1)

    ones = torch.ones((1, 1) + tuple(x.shape[1:-1]), device=x.device)
    return (window_sum(x.movedim(-1, 1)) / window_sum(ones)).movedim(1, -1)


def max_pool_same(x, pool, stride):
    pads = [same_pads(s, pool, stride) for s in x.shape[1:-1]]
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    fn = {2: F.max_pool2d, 3: F.max_pool3d}[x.ndim - 2]
    return fn(F.pad(x.movedim(-1, 1), flat, value=-math.inf), pool, stride).movedim(1, -1)


def align_corners_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        A[:, 0] = 1.0
    elif out_size == 1:
        A[0, 0] = 1.0  # align_corners samples the corner
    if in_size == 1 or out_size == 1:
        return torch.from_numpy(A).to(device)
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * scale
        i0 = min(int(np.floor(src)), in_size - 2)
        A[i, i0] += 1.0 - (src - i0)
        A[i, i0 + 1] += src - i0
    return torch.from_numpy(A).to(device)


def resize_align_corners(x, out_h, out_w):
    """(B, H, W, C) bilinear with align_corners=True, as two interpolation matmuls."""
    B, H, W, C = x.shape
    if (out_h, out_w) == (H, W):
        return x
    y = torch.einsum("ph,bhwc->bpwc", align_corners_matrix(out_h, H, x.device), x)
    return torch.einsum("qw,bpwc->bpqc", align_corners_matrix(out_w, W, x.device), y)


# ---------------------------------------------------------------- feature extraction


def bottleneck(p, name, x, stride=1, rate=1, eps=1e-3):
    """Pre-activation bottleneck unit: preact = relu(bn(x) + beta); 1x1, kxk (dilated,
    fixed padding when strided), 1x1, each with a bias; shortcut identity, strided
    subsample or a 1x1 conv of the preactivation."""
    preact = relu(batch_norm(x, eps, beta=p[f"{name}/preact/beta"]))
    if f"{name}/shortcut/w" in p:
        short = conv(preact, p[f"{name}/shortcut/w"], p[f"{name}/shortcut/b"], stride=stride)
    elif stride == 1:
        short = x
    else:
        short = max_pool_same(x, 1, stride)
    r = conv(preact, p[f"{name}/conv1/w"], p[f"{name}/conv1/b"], act=True)
    if stride == 1:
        r = conv(r, p[f"{name}/conv2/w"], p[f"{name}/conv2/b"], rate=rate, act=True)
    else:
        r = fixed_pad_conv(r, p[f"{name}/conv2/w"], p[f"{name}/conv2/b"], stride, rate, act=True)
    return short + conv(r, p[f"{name}/conv3/w"], p[f"{name}/conv3/b"])


def res_block(p, prefix, x, n, stride=1, rate=1, eps=1e-3):
    names = [prefix] if n == 1 else [f"{prefix}_{i}" for i in range(n - 1)] + [prefix]
    x = bottleneck(p, names[0], x, stride, rate, eps)
    for name in names[1:]:
        x = bottleneck(p, name, x, 1, rate, eps)
    return x


def fem(p, image, eps=1e-3):
    """(B, H, W, 3) -> (B, H/4, W/4, 32)."""
    x = conv_bn(image, p["fem/conv0_0/w"], stride=2, eps=eps)
    x = conv_bn(x, p["fem/conv0_1/w"], eps=eps)
    x = conv_bn(x, p["fem/conv0_2/w"], eps=eps)
    x = res_block(p, "fem/conv0_x", x, 3, eps=eps)
    c1 = res_block(p, "fem/conv1_x", x, 8, stride=2, eps=eps)
    x = res_block(p, "fem/conv2_x", c1, 3, rate=2, eps=eps)
    c3 = res_block(p, "fem/conv3_x", x, 3, rate=4, eps=eps)
    h, w = c3.shape[1], c3.shape[2]
    branches = []
    for i, pool in enumerate(_SPP_POOLS):
        b = conv_bn(avg_pool_same(c3, pool, pool), p[f"fem/branch_{i}_conv/w"], eps=eps)
        branches.append(resize_align_corners(b, h, w))
    x = conv_bn(torch.cat([c1, c3] + branches, dim=-1), p["fem/fusion0/w"], eps=eps)
    return conv(x, p["fem/fusion1/w"])


def fem_shallow(p, image, eps=1e-3):
    """(B, H, W, 3) -> (B, H/4, W/4, 16)."""
    x = res_block(p, "fem_shallow/global_refine_conv0_x", image, 3, stride=4, eps=eps)
    return conv(x, p["fem_shallow/global_refine_shallow_feature/w"])


def features(p, images, shallow=False, eps=1e-3):
    B, N = images.shape[:2]
    out = (fem_shallow if shallow else fem)(p, images.reshape((B * N,) + images.shape[2:]), eps)
    return out.reshape((B, N) + out.shape[1:])


# ---------------------------------------------------------------- 3D U-Nets


def conv3d_mixed(w, varying, const2d, stride=1):
    """conv3d over concat([varying, tile_D(const2d)]): the D-constant channels as 2D convs
    with the kernel summed over its depth taps; SAME drops tap 0 on the first plane and tap
    2 on the last (at stride 2 only the last)."""
    Cv, D = varying.shape[-1], varying.shape[1]
    wc = w[:, Cv:]
    y = conv(varying, w[:, :Cv], stride=stride)

    def conv2(taps):
        return conv(const2d, sum(wc[:, :, t] for t in taps), stride=stride)[:, None]

    Do = D // stride
    head = [conv2((1, 2))] if stride == 1 else []
    mid = conv2((0, 1, 2))
    return y + torch.cat(head + [mid.expand(-1, Do - len(head) - 1, -1, -1, -1),
                                 conv2((0, 1))], dim=1)


def conv3d_mixed_bn(w, varying, const2d, stride=1, eps=1e-3):
    return relu(batch_norm(conv3d_mixed(w, varying, const2d, stride), eps))


def crm(p, warped, ref2d, eps=1e-3):
    """The stacked 3D U-Net over concat(tile_D(ref feature), warped view feature).
    Returns (filtered cost (B, D, h, w, 8), prob (B, D, h, w))."""

    def cbn(name, x, stride=1):
        return conv_bn(x, p[f"crm/{name}/w"], stride=stride, eps=eps)

    def dbn(name, x):
        return deconv_bn(x, p[f"crm/{name}/w"], eps)

    Cc = ref2d.shape[-1]

    def mixed(name, stride):
        w = p[f"crm/{name}/w"]
        # the kernel's in-channels are [reference tile, warped]
        return conv3d_mixed_bn(torch.cat([w[:, Cc:], w[:, :Cc]], dim=1), warped, ref2d,
                               stride, eps)

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
    return filtered, conv(filtered, p["crm/conv_b2_6_2/w"])[..., 0]


def refine_net(p, photo, geo, prob_vol, vis_hull, eps=1e-3):
    """The refinement U-Net over four input groups. photo = (varying (B,D,h,w,16),
    const (B,h,w,32)); geo = (varying (B,D,h,w,2), const (B,h,w,2), F): the view term's
    F identical channels collapse the kernel over them. Returns (cost residual, prob
    residual)."""

    def w(name):
        return p[f"refine/global_refine{name}/w"]

    def cbn(name, x, stride=1):
        return conv_bn(x, w(name), stride=stride, eps=eps)

    def dbn(name, x):
        return deconv_bn(x, w(name), eps)

    ph = conv3d_mixed_bn(w("_photo_3dconv"), photo[0], photo[1], eps=eps)
    vary, const2d, nf = geo
    wg = w("_geo_3dconv")
    wg = torch.cat([wg[:, 0:1], wg[:, 1:1 + nf].sum(dim=1, keepdim=True), wg[:, 1 + nf:]], dim=1)
    ge = conv3d_mixed_bn(wg, vary, const2d, eps=eps)
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
    return c6_1, conv(c6_1, p["refine/global_refined_cost_vol/w"])[..., 0]


def aggregate(p, stage, x):
    """Attention over the pair-leading stack (P, B, D, h, w, C) -> (B, D, h, w, C)."""
    a = f"aam{stage}_att"
    P, B, C = x.shape[0], x.shape[1], x.shape[-1]
    w = torch.cat([p[f"{a}/weight_unique"], p[f"{a}/weight_shared"]], dim=0)
    both = conv(x.reshape((P * B,) + x.shape[2:]), w, act=True).reshape(x.shape[:-1] + (2 * C,))
    unique, shared = both[..., :C], both[..., C:]
    score = torch.softmax(unique - shared + shared.sum(dim=0, keepdim=True), dim=0)
    return torch.sum(score * x, dim=0)


def aggregate_output(p, stage, x):
    name = "aam1_out/attention_prob_vol" if stage == 1 else "aam2_out/attention_prob_vol_refine"
    return conv(x, p[f"{name}/w"])[..., 0]


# ---------------------------------------------------------------- geometry


def split_cam(cam):
    return cam[..., 1, :3, :3], cam[..., 0, :3, :3], cam[..., 0, :3, 3:4]


def pixel_grid(h, w, device):
    x = torch.arange(w, device=device, dtype=torch.float32) + 0.5
    y = torch.arange(h, device=device, dtype=torch.float32) + 0.5
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xg.reshape(-1), yg.reshape(-1), torch.ones_like(xg).reshape(-1)])


def sweep_values(start, interval, d):
    return start[:, None] + torch.arange(d, device=start.device,
                                         dtype=torch.float32)[None] * interval[:, None]


def homographies(left, right, d, start, interval):
    """(B, D, 3, 3): reference pixels to view pixels, one per inverse-depth plane:
    K_r R_r (I - c_rel n^T s) R_l^T K_l^-1."""
    K_l, R_l, t_l = split_cam(left)
    K_r, R_r, t_r = split_cam(right)
    s = sweep_values(start, interval, d)
    R_l_T, R_r_T = R_l.transpose(-1, -2), R_r.transpose(-1, -2)
    c_rel = -(R_r_T @ t_r) + (R_l_T @ t_l)
    temp = c_rel @ R_l[:, 2:3, :]
    eye = torch.eye(3, device=left.device)
    middle = eye[None, None] - temp[:, None] * s[:, :, None, None]
    back = (R_l_T @ torch.linalg.inv(K_l))[:, None]
    return (K_r @ R_r)[:, None] @ (middle @ back)


def sample(image, x, y, bilinear=True, nearest=None):
    """Texture-coordinate sampling: 0.5 is pixel 0's centre; valid inside
    [0, W-1) x [0, H-1); an invalid bilinear sample is 0; nearest rounds half to even and
    reads pixel (0, 0) where invalid. Returns (bilinear, nearest, valid)."""
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
    x0f, x1f, y0f, y1f = (v.to(torch.float32) for v in (x0, x1, y0, y1))
    wa = ((y1f - y) * (x1f - x))[..., None]
    wb = ((y1f - y) * (x - x0f))[..., None]
    wc = ((y - y0f) * (x1f - x))[..., None]
    wd = ((y - y0f) * (x - x0f))[..., None]
    x1, y1 = x1.clamp(max=W - 1), y1.clamp(max=H - 1)
    out = (wa * gather(flat, y0, x0) + wb * gather(flat, y0, x1)
           + wc * gather(flat, y1, x0) + wd * gather(flat, y1, x1))
    return out, near, valid


def _coords(hom, h, w):
    warped = hom @ pixel_grid(h, w, hom.device)
    den = warped[..., 2, :]
    den = den + torch.where(den == 0.0, 1e-7, 0.0)
    return warped[..., 0, :] / den, warped[..., 1, :] / den


def sweep_warp(image, hom):
    """(B, H, W, C) warped by (B, D, 3, 3) -> (B, D, H, W, C), bilinear."""
    B, H, W, C = image.shape
    x, y = _coords(hom, H, W)
    out, _, _ = sample(image, x.reshape(B, -1), y.reshape(B, -1))
    return out.reshape(B, hom.shape[1], H, W, C)


def sweep_warp_with_nearest(image, hom, nearest):
    B, H, W, C = image.shape
    D = hom.shape[1]
    x, y = _coords(hom, H, W)
    bil, near, valid = sample(image, x.reshape(B, -1), y.reshape(B, -1), nearest=nearest)
    return (bil.reshape(B, D, H, W, C), near.reshape(B, D, H, W, -1),
            valid.reshape(B, D, H, W, 1))


def _relative(left, right):
    K_l, R_l, t_l = split_cam(left)
    K_r, R_r, t_r = split_cam(right)
    R_l_T = R_l.transpose(-1, -2)
    c_l = -(R_l_T @ t_l)
    M = (K_r @ R_r) @ (R_l_T @ torch.linalg.inv(K_l))
    v = K_r @ (R_r @ c_l) + K_r @ t_r
    return M, v


def warp_by_depth(image, left, right, depth, nearest=False):
    """The right image at the left pixels' projections through the left inverse depth."""
    B, H, W, C = image.shape
    M, v = _relative(left, right)
    warped = M @ pixel_grid(H, W, image.device) + v * depth.reshape(B, 1, H * W)
    x, y = warped[:, 0, :] / warped[:, 2, :], warped[:, 1, :] / warped[:, 2, :]
    if nearest:
        _, out, valid = sample(image, x, y, bilinear=False, nearest=slice(None))
    else:
        out, _, valid = sample(image, x, y)
    return out.reshape(B, H, W, C), valid.reshape(B, H, W, 1)


def transform_depth(depth, left, right):
    """Left inverse depths re-expressed in the right camera (pixels stay put)."""
    shape = depth.shape
    B, H, W = shape[:3]
    d = depth.reshape(B, 1, H * W)
    pos = d > 1e-10
    z = torch.where(pos, 1.0 / d.clamp(min=1e-10), 0.0)
    M, v = _relative(left, right)
    z_out = (M @ (pixel_grid(H, W, depth.device) * z) + v)[:, 2:3, :]
    return torch.where(pos, 1.0 / z_out.clamp(min=1e-10), 0.0).reshape(shape)


# ---------------------------------------------------------------- depth regression


def softargmin(cost, start, interval, with_confidence=False):
    """depth = sum_d sweep_d softmax_d(-cost), (B, h, w, 1); with_confidence also the
    summed probability of the 4 planes around it (an integral estimate counts its own
    plane twice)."""
    D = cost.shape[1]
    prob = torch.softmax(-cost, dim=1)
    s = sweep_values(start, interval, D)
    depth = torch.sum(s[:, :, None, None] * prob, dim=1)[..., None]
    if not with_confidence:
        return depth
    idx = (depth[..., 0] - start[:, None, None]) / interval[:, None, None]
    l0 = torch.floor(idx).long().clamp(0, D - 1)
    r0 = torch.ceil(idx).long().clamp(0, D - 1)
    conf = sum(torch.gather(prob, 1, i[:, None])[:, 0]
               for i in (l0, (l0 - 1).clamp(0, D - 1), r0, (r0 + 1).clamp(0, D - 1)))
    return depth, conf[..., None]


def _row_tile(total, target=128):
    for t in range(min(target, total), 0, -1):
        if total % t == 0:
            return t
    return 1


def softargmin_upsampled(cost, start, interval, scale=4):
    """The soft-argmin and confidence of the cost volume resized 4x (align corners),
    in tiles of output rows."""
    B, D, h, w = cost.shape
    Ho, Wo = h * scale, w * scale
    cw = torch.einsum("qw,bdhw->bdhq", align_corners_matrix(Wo, w, cost.device), cost)
    Ah = align_corners_matrix(Ho, h, cost.device)
    t = _row_tile(Ho)
    outs = [softargmin(torch.einsum("th,bdhq->bdtq", Ah[r:r + t], cw), start, interval, True)
            for r in range(0, Ho, t)]
    return torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1)


# ---------------------------------------------------------------- the pipeline


def refinement(p, depth_ref, depth_view, ref_cam, view_cam, shallow_ref, shallow_view,
               prob_vol, start, interval, eps=1e-3):
    D = prob_vol.shape[1]
    nf = shallow_ref.shape[-1]
    dvt = transform_depth(depth_view, view_cam, ref_cam)
    hom = homographies(ref_cam, view_cam, D, start, interval)
    warped, near, mask = sweep_warp_with_nearest(torch.cat([shallow_view, dvt], dim=-1), hom,
                                                 slice(nf, nf + 1))
    photo_vol = (warped[..., :nf] - shallow_ref[:, None]).abs() * mask.float()
    sweep = sweep_values(start, interval, D)[:, :, None, None, None]
    denom = (interval * D)[:, None, None, None, None]
    geo_ref = (depth_ref[:, None] - sweep).abs() / denom
    geo_view = (warped[..., nf:] - sweep).abs() / denom * mask.float()
    warped_f, mask_p = warp_by_depth(shallow_view, ref_cam, view_cam, depth_ref)
    photo_err = (warped_f - shallow_ref).abs() * mask_p.float()
    warped_d, mask_g = warp_by_depth(dvt, ref_cam, view_cam, depth_ref, nearest=True)
    geo_err = (warped_d - depth_ref).abs() * mask_g.float()
    sweep_hw = sweep[..., 0]

    def free_space(d):
        return ((d > 0) & (d > sweep_hw)).float()

    hull = (free_space(depth_ref[..., 0][:, None]) + free_space(near[..., 0])) / 2.0
    return refine_net(p, (photo_vol, torch.cat([photo_err, shallow_ref], dim=-1)),
                      (torch.cat([geo_ref, geo_view], dim=-1),
                       torch.cat([geo_err, depth_ref], dim=-1), nf),
                      prob_vol[..., None], hull[..., None], eps)


def center_images(images):
    """Per-image, per-channel variance normalization of (..., H, W, C) frames."""
    x = images.to(torch.float32)
    mean = x.mean(dim=(-3, -2), keepdim=True)
    var = (x.square().mean(dim=(-3, -2), keepdim=True) - mean.square()).clamp(min=0.0)
    return (x - mean) / (torch.sqrt(var) + 1e-8)


def to_metric(sweep_depth):
    """Inverse-depth sweep values to metric depth; non-positive ones to 0."""
    return torch.where(sweep_depth < 1e-10, 0.0, 1.0 / sweep_depth.clamp(min=1e-10))


@torch.no_grad()
def forward(p, images, cams, D, upsample=True, eps=1e-3):
    """images (B, N, H, W, 3) normalized, cams (B, N, 2, 4, 4) with cost-volume
    intrinsics and the inverse-depth sweep row, D planes -> depth and confidence in sweep
    units, at the cost volume's resolution and (upsample) 4x: a dict of (B, h, w, 1)
    maps."""
    N = images.shape[1]
    start, interval = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
    feats = features(p, images, eps=eps)
    shallow = features(p, images, shallow=True, eps=eps)
    ref_f, ref_cam = feats[:, 0], cams[:, 0]

    costs, views = [], []
    for i in range(1, N):
        hom = homographies(ref_cam, cams[:, i], D, start, interval)
        filtered, _ = crm(p, sweep_warp(feats[:, i], hom), ref_f, eps)
        hom_v = homographies(cams[:, i], ref_cam, D, start, interval)
        _, prob_v = crm(p, sweep_warp(ref_f, hom_v), feats[:, i], eps)
        costs.append(filtered)
        views.append(softargmin(prob_v, start, interval))
    cost_agg = aggregate(p, 1, torch.stack(costs))
    del costs
    prob_agg = aggregate_output(p, 1, cost_agg)
    depth_agg, _ = softargmin(prob_agg, start, interval, True)

    refined = []
    for i in range(1, N):
        cost_res, _ = refinement(p, depth_agg, views[i - 1], ref_cam, cams[:, i],
                                 shallow[:, 0], shallow[:, i], prob_agg, start, interval, eps)
        refined.append(cost_agg + cost_res)
    final = aggregate_output(p, 2, aggregate(p, 2, torch.stack(refined)))
    depth, conf = softargmin(final, start, interval, True)
    out = {"depth": depth, "confidence": conf}
    if upsample:
        out["depth_up"], out["confidence_up"] = softargmin_upsampled(final, start, interval)
    return out
