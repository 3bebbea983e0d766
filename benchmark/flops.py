"""The FLOPs of one A-TVSNet forward, counted from its shapes.

Two FLOPs per multiply-add of every convolution, transposed convolution and matrix
product that the forward runs, whatever algorithm computes it (an FFT convolution does
other arithmetic; the count is the algorithm-free one). The same convention as
torch.utils.flop_counter.FlopCounterMode: a convolution counts its output positions, a
transposed convolution its input positions, times the kernel's taps and both channel
counts; a product of (m, k) by (k, n) counts 2 m k n. The tests hold this count to
FlopCounterMode over the port's forward at small sizes.

What it follows: the stages of the published network at the sizes a run uses, with the
D-constant half of each cost volume entering the U-Nets' first convolutions as 2D
convolutions (the port and the reference both compute it so), every TF-SAME output size
ceil(n / stride), and the two 4x upsampling products of the served forward.
"""

from __future__ import annotations

import math


def _ceil(n, s):
    return -(-n // s)


def conv(batch, out_spatial, cin, cout, k, nd):
    return 2 * batch * math.prod(out_spatial) * cin * cout * k ** nd


def deconv(batch, in_spatial, cin, cout, k=3):
    return 2 * batch * math.prod(in_spatial) * cin * cout * k ** len(in_spatial)


def mm(m, k, n):
    return 2 * m * k * n


def _bottleneck(n, size, cin, depth, stride, k=3):
    out = tuple(_ceil(s, stride) for s in size)
    f = conv(n, size, cin, depth, 1, 2)                  # conv1 at the input's size
    f += conv(n, out, depth, depth, k, 2)                # conv2, strided
    f += conv(n, out, depth, depth, 1, 2)                # conv3
    if cin != depth:
        f += conv(n, out, cin, depth, 1, 2)              # shortcut
    return f, out


def _res_block(n, size, cin, depth, blocks, stride):
    f, size = _bottleneck(n, size, cin, depth, stride)
    for _ in range(blocks - 1):
        g, size = _bottleneck(n, size, depth, depth, 1)
        f += g
    return f, size


def _resize(n, hin, win, hout, wout, c):
    """The align-corners resize as two interpolation products (none when sizes agree). A
    product over a contraction of length 1 is a broadcast multiply, not a matrix product,
    and FlopCounterMode leaves it out."""
    if (hin, win) == (hout, wout):
        return 0
    return (mm(hout, hin, n * win * c) if hin > 1 else 0) + (
        mm(wout, win, n * hout * c) if win > 1 else 0)


def fem(n, H, W, f=32):
    h2 = (_ceil(H, 2), _ceil(W, 2))
    total = conv(n, h2, 3, f, 3, 2) + 2 * conv(n, h2, f, f, 3, 2)
    g, size = _res_block(n, h2, f, f, 3, 1)
    total += g
    g, size = _res_block(n, size, f, 2 * f, 8, 2)
    total += g
    g, size = _res_block(n, size, 2 * f, 4 * f, 3, 1)
    total += g
    g, size = _res_block(n, size, 4 * f, 4 * f, 3, 1)
    total += g
    for pool in (64, 32, 16, 8):
        pooled = (_ceil(size[0], pool), _ceil(size[1], pool))
        total += conv(n, pooled, 4 * f, f, 3, 2) + _resize(n, *pooled, *size, f)
    total += conv(n, size, 10 * f, 4 * f, 3, 2) + conv(n, size, 4 * f, f, 1, 2)
    return total


def fem_shallow(n, H, W, f=16):
    g, size = _res_block(n, (H, W), 3, f, 3, 4)
    return g + conv(n, size, f, f, 1, 2)


def _unet(B, vol, c, trunk_in):
    """The convolutions of one U-Net block after its entry convs; vol = (D, h, w)."""
    lv = [tuple(s // 2 ** i for s in vol) for i in range(4)]
    f = conv(B, lv[1], trunk_in, 2 * c, 3, 3) if trunk_in else 0
    f += conv(B, lv[2], 2 * c, 4 * c, 3, 3) + conv(B, lv[3], 4 * c, 8 * c, 3, 3)
    f += conv(B, lv[1], 2 * c, 2 * c, 3, 3) + conv(B, lv[2], 4 * c, 4 * c, 3, 3)
    f += conv(B, lv[3], 8 * c, 8 * c, 3, 3)
    f += deconv(B, lv[3], 8 * c, 4 * c) + deconv(B, lv[2], 4 * c, 2 * c)
    f += deconv(B, lv[1], 2 * c, c)
    return f


def _mixed(B, vol, cv, cc, cout, stride):
    """A 3D conv over concat(varying, tile_D(const)) as one 3D conv of the varying
    channels and, for the constant ones, 3 (stride 1) or 2 (stride 2) 2D convs."""
    out = tuple(s // stride for s in vol)
    return conv(B, out, cv, cout, 3, 3) + (3 if stride == 1 else 2) * conv(
        B, out[1:], cc, cout, 3, 2)


def crm(B, vol, feat, c=8):
    """One pass of the stacked U-Net over a cost volume of `feat` warped plus `feat`
    reference channels, with its 1-channel output conv."""
    f = _mixed(B, vol, feat, feat, 2 * c, 2) + _mixed(B, vol, feat, feat, c, 1)
    f += _unet(B, vol, c, 0)
    for _ in range(2):
        f += conv(B, vol, c, c, 3, 3) + _unet(B, vol, c, c)
    return f + conv(B, vol, c, 1, 3, 3)


def refine(B, vol, fs=16, c=8):
    f = _mixed(B, vol, fs, 2 * fs, c, 1) + _mixed(B, vol, 2, 2, c, 1)
    f += 2 * conv(B, vol, 1, c, 3, 3)
    f += conv(B, vol, 4 * c, c, 3, 3) + _unet(B, vol, c, 4 * c)
    return f + conv(B, vol, c, 1, 3, 3)


def aam(P, B, vol, c=8):
    return conv(P * B, vol, c, 2 * c, 3, 3) + conv(B, vol, c, 1, 3, 3)


def _cam_algebra(B):
    """The 3x3 camera products of one relative projection."""
    return 3 * mm(3, 3, 3) * B + 4 * mm(3, 3, 1) * B


def _homographies(B, D):
    return B * (2 * mm(3, 3, 1) + mm(3, 1, 3) + 2 * mm(3, 3, 3)) + 2 * B * D * mm(3, 3, 3)


def geometry(B, P, D, h, w):
    """The projective products: per pair two sweeps of the stage-1 volumes, and the
    refinement's sweep, depth transform and two depth-driven warps."""
    hw = h * w
    sweep = _homographies(B, D) + mm(B * D * 3, 3, hw)
    stage1 = 2 * sweep
    refinement = sweep + 3 * _cam_algebra(B) + B * mm(3, 3, hw) + 2 * mm(B * 3, 3, hw)
    return P * (stage1 + refinement)


def forward_flops(views, H, W, D, batch=1, upsample=True, fem_f=32, shallow_f=16, crm_f=8,
                  refine_f=8) -> dict:
    """FLOPs of one forward of `batch` samples, by stage, and their 'total'."""
    B, P = batch, views - 1
    h, w = _ceil(_ceil(H, 2), 2), _ceil(_ceil(W, 2), 2)
    vol = (D, h, w)
    out = {
        "fem": fem(B * views, H, W, fem_f),
        "fem_shallow": fem_shallow(B * views, H, W, shallow_f),
        "stage1_crm": P * 2 * crm(B, vol, fem_f, crm_f),
        "aam": 2 * aam(P, B, vol, crm_f),
        "refine": P * refine(B, vol, shallow_f, refine_f),
        "geometry": geometry(B, P, D, h, w),
        "upsample": (mm(4 * w, w, B * D * h) + mm(4 * h, h, B * D * 4 * w)) if upsample else 0,
    }
    out["total"] = sum(out.values())
    return out
