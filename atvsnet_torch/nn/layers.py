"""NN primitives with the reference's TF-1 semantics (atvsnet_tpu/nn/layers.py).

Activations are channel-last (NHWC / NDHWC) at every public function, as in the JAX
package. Internally each conv runs on a channel-first *view* of the same memory
(`movedim`), which PyTorch treats as the channels_last memory format: no copies.

Weights are stored in PyTorch's layout: conv (out, in, k...), transpose conv
(in, out, k...); params.py converts from the JAX package's TF layout.

  * conv: TF-SAME padding, which is asymmetric where PyTorch's is not: a k3 stride-2
    conv on an even size pads (0, 1), never (1, 1).
  * batch_stat_norm: per-sample, per-channel statistics over the spatial axes, biased
    variance as E[x^2] - mean^2, eps 1e-3, no affine. No torch BatchNorm mode matches.
  * deconv: TF conv_transpose SAME, the exact transpose of the SAME strided conv.
  * avg_pool_same: padding is left out of the mean.
  * activate (the ReLU): max(y, 0) as jnp.maximum takes it, which splits the gradient of
    a tie evenly; torch.relu gives a tie no gradient. Ties are real here: batch_stat_norm
    maps a channel that is constant over the map to exact zeros.

Every conv, transposed conv and matmul leaf takes `precision` (PipelineConfig.fp32_precision,
"highest" by default): with a float32 operand it runs in that mode's arithmetic, forward and
both gradients (ops.fp32_passes: TF32 off for "highest", the bf16 passes on the TF32 tensor
cores for "high" and "default"), as the JAX package's _precision_for does; a bf16 operand
runs as before, whatever the mode, and so do the int8mxu convs. A float32 conv with groups
1 in "highest" runs its forward on a CUDA kernel of the port, 2D convs on ops.conv2d_fp32's
(an fp32 implicit GEMM) and 3x3x3 3D convs at rate 1 on ops.conv3d_fp32's (an fp32 direct
convolution), on the CPU the same pass_conv call as the other modes, and its gradients as
pass_conv's. So does a float32 3x3x3 stride-2 3D deconv in "highest", on
ops.conv3d_transpose_fp32's kernel (a parity decomposition that writes the cropped output),
its gradients as pass_conv_transpose's.

Two options reach the 5D (B, D, h, w, C) volume ops as explicit arguments:
  * quant (ActQuant, PipelineConfig.act_quant): every volume conv_bn / deconv_bn /
    conv3d_mixed_bn output round-trips through an int8 lattice (`quantize_act`, the JAX
    package's _maybe_quant_act). Under "int8mxu" the volume convs that the caller marks
    `qin=True` also run on int8 operands with int32 sums (`quant_conv_operands`, then
    ops.int8_conv.conv3d_int8: a CUDA kernel on the tensor cores for CUDA tensors);
  * split (parallel.depth.DepthSplit): the volume holds this rank's block of the D planes
    of a 'depth' mesh axis; convs and transposed convs exchange one halo plane with their
    neighbours, batch_stat_norm sums its statistics over the depth group.

The TPU package's depth-tap decompositions of 3D convs are TPU layout work and are not
ported: a float32 3D conv in "highest" here is one launch of ops.conv3d_fp32's kernel, in
the other modes or in bf16 one cuDNN conv3d.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as tnn
import torch.nn.functional as F

from atvsnet_torch.ops.conv2d_fp32 import conv2d_fp32
from atvsnet_torch.ops.conv3d_fp32 import conv3d_fp32
from atvsnet_torch.ops.conv3d_fp32 import takes as conv3d_fp32_takes
from atvsnet_torch.ops.conv3d_transpose_fp32 import conv3d_transpose_fp32
from atvsnet_torch.ops.conv3d_transpose_fp32 import takes as conv3d_transpose_fp32_takes
from atvsnet_torch.ops.fp32_passes import (pass_conv, pass_conv_transpose, pass_matmul,
                                           padded_channels_first)
from atvsnet_torch.ops.int8_conv import conv3d_int8
from atvsnet_torch.utils.profiling import TRACER

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


# a CPU scalar: binary ops take it beside a tensor on any device, with no allocation there
_ZERO = torch.zeros(())


def activate(y: torch.Tensor) -> torch.Tensor:
    """The ReLU: max(y, 0) with jnp.maximum's gradient, 1/2 at y == 0 (torch.relu gives 0
    there). The values are relu's."""
    return torch.maximum(y, _ZERO)


def _same_pads(in_size: int, k: int, stride: int, rate: int = 1):
    """TF 'SAME' padding (beg, end) for one axis."""
    k_eff = k + (k - 1) * (rate - 1)
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k_eff - in_size, 0)
    return total // 2, total - total // 2


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _padded_conv(x: torch.Tensor, w: torch.Tensor, b, stride: int, rate: int, pads,
                 groups: int = 1, precision: str = "highest"):
    """Channel-last conv with explicit per-axis (beg, end) pads; a float32 x runs in the
    `precision` mode's arithmetic (ops.fp32_passes.pass_conv), and a float32 conv with groups
    1 in "highest" on ops.conv2d_fp32 (2D) or ops.conv3d_fp32 (3D, 3x3x3, rate 1, stride 1
    or 2): the CUDA kernels for CUDA tensors."""
    nd = x.ndim - 2
    if x.dtype == torch.float32 and groups == 1 and precision == "highest":
        bias = None if b is None else b.to(x.dtype)
        if nd == 2:
            return conv2d_fp32(x, w.to(x.dtype), bias, stride, rate, pads)
        if nd == 3 and conv3d_fp32_takes(w.shape, stride, rate):
            return conv3d_fp32(x, w.to(x.dtype), bias, stride, rate, pads)
    xc, padding = padded_channels_first(x, pads)
    if x.dtype == torch.float32:
        return _channels_last(pass_conv(xc, w.to(x.dtype), precision, stride, padding, rate,
                                        groups, None if b is None else b.to(x.dtype)))
    y = _CONV[nd](xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                  stride=stride, padding=padding, dilation=rate, groups=groups)
    return _channels_last(y)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         stride: int = 1, rate: int = 1, relu: bool = False, split=None,
         quant: Optional["ActQuant"] = None, qin: bool = False,
         precision: str = "highest") -> torch.Tensor:
    """Rank-dispatching TF-SAME conv on channel-last x; w is (out, in, k...).

    split: x is this rank's block of D planes (a 5D volume, a k3 kernel, stride 1 or 2).
    TF-SAME pads D by (1, 1) at stride 1 and by (0, 1) at stride 2 on an even D, so the
    block takes one plane from each neighbour, or from its right one only, and zeros at
    the global ends.

    qin ("quantized input ok"): the caller says that x is a stored lattice link, or a small
    sum or convex mix of such links. Under quant.mode "int8mxu" such a conv of a 5D x with
    a depth kernel of 3, no bias, rate 1 and stride 1 or 2 runs on int8 operands with int32
    sums (quant_conv_operands), rescaled to x's dtype, where the JAX package does
    (atvsnet_tpu/nn/layers.py:231-233). A split's halo comes first: the quantization is
    elementwise, so a split and one process give the same bits. Ignored otherwise.

    precision: the fp32_precision mode of a float32 x (not of the int8 route)."""
    if split is not None and x.ndim == 5:
        if w.shape[2] != 3 or rate != 1 or stride not in (1, 2) or x.shape[1] % stride:
            raise ValueError(f"a depth-split conv needs a depth kernel of 3, rate 1 and "
                             f"stride 1 or 2 on an even block; got k={w.shape[2]}, "
                             f"rate={rate}, stride={stride}, planes={x.shape[1]}")
        x = split.halo(x, left=1 if stride == 1 else 0, right=1)
        pads = [(0, 0)] + [_same_pads(s, k, stride) for s, k in zip(x.shape[2:-1], w.shape[3:])]
    else:
        pads = [_same_pads(s, k, stride, rate) for s, k in zip(x.shape[1:-1], w.shape[2:])]
    if (qin and quant is not None and quant.mode == "int8mxu" and b is None and x.ndim == 5
            and w.shape[2] == 3 and rate == 1 and stride in (1, 2)):
        xq, wq, scale = quant_conv_operands(x, w, quant.range)
        y = conv3d_int8(xq.contiguous(), wq, stride, pads, scale, x.dtype)
    else:
        y = _padded_conv(x, w, b, stride, rate, pads, precision=precision)
    return activate(y) if relu else y


def fixed_pad_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   stride: int = 2, rate: int = 1, relu: bool = False,
                   precision: str = "highest") -> torch.Tensor:
    """Explicit-padding strided conv (resnet 'fixed padding', reference network.py:589-595)."""
    k = w.shape[2]
    pad_total = k + (k - 1) * (rate - 1) - 1
    pads = [(pad_total // 2, pad_total - pad_total // 2)] * (x.ndim - 2)
    y = _padded_conv(x, w, b, stride, rate, pads, precision=precision)
    return activate(y) if relu else y


def batch_stat_norm(x: torch.Tensor, eps: float = 1e-3,
                    beta: Optional[torch.Tensor] = None, split=None) -> torch.Tensor:
    """Normalize by per-sample statistics over the spatial axes (training-mode BN at
    batch 1, the only regime the reference runs). Statistics accumulate in fp32; with a
    depth split (a 5D x) the sums and E[x^2]'s are summed over the depth group first."""
    axes = tuple(range(1, x.ndim - 1))
    xf = x.to(torch.float32)
    if split is not None and x.ndim == 5:
        count = math.prod(x.shape[1:-1]) * split.size
        sums = split.all_sum(torch.stack([xf.sum(dim=axes, keepdim=True),
                                          xf.square().sum(dim=axes, keepdim=True)]))
        mean = sums[0] / count
        var = sums[1] / count - mean.square()
    else:
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.square().mean(dim=axes, keepdim=True) - mean.square()
    if x.dtype == torch.float32:
        y = (x - mean) * torch.rsqrt(var + eps)
    else:
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    if beta is not None:
        y = y + beta.to(y.dtype)
    return y


@dataclasses.dataclass(frozen=True)
class ActQuant:
    """Quantization of the volume links (PipelineConfig.act_quant "int8", "int8s" or
    "int8mxu", and act_quant_range). "int8mxu" stores the links as "int8s" does and also
    runs the qin volume convs on int8 operands (conv)."""

    mode: str
    range: float = 6.0

    @classmethod
    def of(cls, cfg) -> Optional["ActQuant"]:
        """The config's quantization, or None for act_quant="none"."""
        return None if cfg.act_quant == "none" else cls(cfg.act_quant, cfg.act_quant_range)


def _scalar(v: float, device) -> torch.Tensor:
    """An fp32 scalar on `device`: a divisor there divides element by element, where a
    Python float may be turned into a multiply by its reciprocal (CUDA does)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def quantize_act(y: torch.Tensor, quant: Optional[ActQuant], nonneg: bool = False,
                 split=None) -> torch.Tensor:
    """The int8 round trip of a 5D volume link (atvsnet_tpu/nn/layers.py:_maybe_quant_act);
    anything else, or quant None, passes unchanged.

      int8   a dynamic per-tensor scale, max|y| / 127 + 1e-12 (over the depth group with
             a split), onto [-127, 127];
      int8s  a static scale: range / 255 onto [0, 255] for a relu link (nonneg), range /
             127 onto [-127, 127] otherwise;
      int8mxu  the links as int8s.

    fp32 arithmetic with the scale as an fp32 scalar, as the JAX package's weakly typed
    Python floats give it, and round half to even in both: the same y gives the same bits.
    The result has y's dtype. Inference only: round() has no gradient.

    While a profiler records (utils.profiling.TRACER), a quantized link is the span
    `quant.act`, with CUDA events on a CUDA y, and adds its elements to the counter
    `quant.act.elements`; quant None records nothing.
    """
    if quant is None or y.ndim != 5:
        return y
    with TRACER.span("quant.act", device=y.device, chain=False):
        TRACER.count("quant.act.elements", y.numel())
        yf = y.to(torch.float32)
        if quant.mode == "int8":
            peak = yf.abs().amax()
            if split is not None:
                peak = split.all_max(peak)
            s = peak / _scalar(127.0, y.device) + 1e-12
            lo, hi = -127.0, 127.0
        elif quant.mode in ("int8s", "int8mxu"):
            s = _scalar(quant.range / (255.0 if nonneg else 127.0), y.device)
            lo, hi = (0.0, 255.0) if nonneg else (-127.0, 127.0)
        else:
            raise ValueError(f"act_quant={quant.mode!r}: expected int8, int8s or int8mxu")
        q = torch.clamp(torch.round(yf / s), lo, hi).to(torch.uint8 if lo == 0.0 else torch.int8)
        return (q.to(torch.float32) * s).to(y.dtype)


def quant_conv_operands(x: torch.Tensor, w: torch.Tensor, range_: float):
    """The int8 operands of an int8mxu conv (atvsnet_tpu/nn/layers.py:_quant_conv_operands):
    x onto the signed +-range lattice, si = range / 127; w per tensor, sw = max|w| / 127 +
    1e-12; both rounded half to even and clipped to [-127, 127]. Returns (xq int8, wq int8,
    si * sw), the last an fp32 scalar tensor that turns the int32 sums back into x's scale.
    fp32 arithmetic with fp32 scalar divisors, as in quantize_act: the same bits as JAX's.
    Traced as the span `quant.operands` (the conv itself is not inside it), which adds the
    elements of x and w to the counter `quant.operands.elements`."""
    with TRACER.span("quant.operands", device=x.device, chain=False):
        TRACER.count("quant.operands.elements", x.numel() + w.numel())
        si = _scalar(range_ / 127.0, x.device)
        xq = torch.clamp(torch.round(x.to(torch.float32) / si), -127.0, 127.0).to(torch.int8)
        wf = w.to(torch.float32)
        sw = wf.abs().amax() / _scalar(127.0, w.device) + 1e-12
        wq = torch.clamp(torch.round(wf / sw), -127.0, 127.0).to(torch.int8)
        return xq, wq, si * sw


def conv_bn(x: torch.Tensor, w: torch.Tensor, stride: int = 1, rate: int = 1,
            relu: bool = True, eps: float = 1e-3, quant: Optional[ActQuant] = None,
            split=None, qin: bool = False, precision: str = "highest") -> torch.Tensor:
    """conv -> batch_stat_norm -> relu (reference network.py:172-215) -> quantize_act; qin
    and precision as in conv."""
    y = batch_stat_norm(conv(x, w, stride=stride, rate=rate, split=split, quant=quant, qin=qin,
                             precision=precision), eps=eps, split=split)
    return quantize_act(activate(y) if relu else y, quant, nonneg=relu, split=split)


def deconv(x: torch.Tensor, w: torch.Tensor, stride: int = 2, relu: bool = False,
           split=None, precision: str = "highest") -> torch.Tensor:
    """TF conv{2,3}d_transpose, SAME: the transpose of the SAME strided conv from the
    stride-times larger output. w is PyTorch's transpose layout (in, out, k...).

    PyTorch's conv_transpose with padding 0 covers the forward conv's padded input;
    cropping [pad_beg, pad_beg + out) removes the SAME padding (pad_beg = 0 for k3 s2).

    split (a 5D x, k3 s2): output plane 2i takes inputs i and i - 1, so the block takes
    its left neighbour's last plane (zeros at the global start) and the crop on D starts
    `stride` planes later.

    precision: the fp32_precision mode of a float32 x, the JAX package's vjp of its conv
    carrying the conv's precision to the transpose. A float32 3x3x3 stride-2 deconv in
    "highest" runs on ops.conv3d_transpose_fp32, which writes the cropped output itself: its
    CUDA kernel for CUDA tensors, this same pass_conv_transpose call and crop for CPU ones.
    """
    nd = x.ndim - 2
    out_sizes = [s * stride for s in x.shape[1:-1]]
    begs = [_same_pads(o, k, stride)[0] for o, k in zip(out_sizes, w.shape[2:])]
    if split is not None and x.ndim == 5:
        if w.shape[2] != 3 or stride != 2:
            raise ValueError(f"a depth-split deconv needs k=3, stride 2; got "
                             f"k={w.shape[2]}, stride={stride}")
        begs[0] = _same_pads(out_sizes[0] * split.size, 3, stride)[0] + stride
        x = split.halo(x, left=1, right=0)
    if (x.dtype == torch.float32 and precision == "highest"
            and conv3d_transpose_fp32_takes(w.shape, stride)):
        y = conv3d_transpose_fp32(x, w.to(x.dtype), begs)
    else:
        if x.dtype == torch.float32:
            y = pass_conv_transpose(_channels_first(x), w.to(x.dtype), precision, stride)
        else:
            y = _CONV_T[nd](_channels_first(x), w.to(x.dtype), stride=stride)
        crop = tuple(slice(b, b + o) for b, o in zip(begs, out_sizes))
        y = _channels_last(y[(slice(None), slice(None)) + crop])
    return activate(y) if relu else y


def deconv_bn(x: torch.Tensor, w: torch.Tensor, stride: int = 2, relu: bool = True,
              eps: float = 1e-3, quant: Optional[ActQuant] = None, split=None,
              precision: str = "highest") -> torch.Tensor:
    y = batch_stat_norm(deconv(x, w, stride=stride, split=split, precision=precision), eps=eps,
                        split=split)
    return quantize_act(activate(y) if relu else y, quant, nonneg=relu, split=split)


def avg_pool_same(x: torch.Tensor, pool: int, stride: int) -> torch.Tensor:
    """SAME average pooling that leaves the padding out of the mean (TF semantics)."""
    nd = x.ndim - 2
    pads = [_same_pads(s, pool, stride) for s in x.shape[1:-1]]
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    pool_fn = {2: F.avg_pool2d, 3: F.avg_pool3d}[nd]

    def window_sum(t):
        return pool_fn(F.pad(t, flat), pool, stride, divisor_override=1)

    summed = window_sum(_channels_first(x.to(torch.float32)))
    ones = torch.ones((1, 1) + tuple(x.shape[1:-1]), device=x.device, dtype=torch.float32)
    return _channels_last(summed / window_sum(ones)).to(x.dtype)


def max_pool_same(x: torch.Tensor, pool: int, stride: int) -> torch.Tensor:
    """SAME max pooling; -inf padding never wins the max."""
    nd = x.ndim - 2
    pads = [_same_pads(s, pool, stride) for s in x.shape[1:-1]]
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    pool_fn = {2: F.max_pool2d, 3: F.max_pool3d}[nd]
    xc = F.pad(_channels_first(x), flat, value=-math.inf)
    return _channels_last(pool_fn(xc, pool, stride))


def l2_pool_same(x: torch.Tensor, pool: int, stride: int) -> torch.Tensor:
    """sqrt(avg_pool_same(x^2)) (reference network.py:673-680)."""
    return torch.sqrt(avg_pool_same(x.square(), pool, stride))


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          relu: bool = True, precision: str = "highest") -> torch.Tensor:
    """Fully connected layer over the last axis (reference 'fc', network.py:709-716). w is
    (in, out), as the JAX package holds it: params.py copies 2D arrays unchanged. A float32
    x multiplies in the `precision` mode's arithmetic."""
    if x.dtype == torch.float32:
        y = pass_matmul(x, w.to(x.dtype), precision)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return activate(y) if relu else y


def dropout(x: torch.Tensor, keep_prob: float = 0.9, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (reference network.py:752-763): each element is kept with
    probability keep_prob and scaled by 1 / keep_prob. The identity at inference or for
    keep_prob >= 1. The mask is drawn from `generator` (on x's device), or from torch's
    default generator when it is None."""
    if not training or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0).to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit norm along dim (reference 'l2norm', network.py:765-767): x * rsqrt(max(sum x^2,
    eps)) in fp32, cast back. F.normalize clamps the norm instead of its square, which
    differs for vectors shorter than sqrt(eps)."""
    xf = x.to(torch.float32)
    sq = xf.square().sum(dim=dim, keepdim=True)
    return (xf * torch.rsqrt(torch.clamp(sq, min=eps))).to(x.dtype)


def split_separable_conv2d(x: torch.Tensor, depthwise_w: torch.Tensor,
                           pointwise_w: torch.Tensor,
                           depthwise_b: Optional[torch.Tensor] = None,
                           pointwise_b: Optional[torch.Tensor] = None,
                           rate: int = 1, precision: str = "highest") -> torch.Tensor:
    """Depthwise conv -> relu -> 1x1 pointwise conv -> relu (reference
    network.py:218-268; slim adds a bias and a relu to both halves), TF-SAME, the
    depthwise conv dilated by `rate`.

    depthwise_w: (1, C, kh, kw), the TF depthwise kernel (kh, kw, C, 1) through
    tf_to_torch; it runs as the grouped conv kernel (C, 1, kh, kw). pointwise_w:
    (Cout, C, 1, 1). precision: both halves' fp32_precision mode.
    """
    C = x.shape[-1]
    pads = [_same_pads(s, k, 1, rate) for s, k in zip(x.shape[1:-1], depthwise_w.shape[2:])]
    y = _padded_conv(x, depthwise_w.transpose(0, 1), depthwise_b, 1, rate, pads, groups=C,
                     precision=precision)
    return conv(activate(y), pointwise_w, pointwise_b, relu=True, precision=precision)


def conv3d_mixed(w: torch.Tensor, varying: torch.Tensor, const2d: torch.Tensor,
                 stride: int = 1, split=None, quant: Optional[ActQuant] = None,
                 qin: bool = False, precision: str = "highest") -> torch.Tensor:
    """conv3d over concat([varying, broadcast_D(const2d)], -1) without the broadcast.

    The D-constant channels reduce to 2D convs with the kernel summed over its depth
    taps (exact, including TF-SAME zero padding on D). w: (Cout, Cv + Cc, 3, kh, kw);
    varying: (B, D, h, w, Cv); const2d: (B, h, w, Cc).

    With a depth split, varying holds this rank's planes: its half exchanges halos (conv),
    and the edge taps are left out only at the global ends, on the first and last rank;
    planes beside a seam between ranks take all three taps. The split path subtracts the
    missing tap's 2D conv where a mask over the planes says so, the same operations on
    every rank (see parallel.depth.DepthSplit.halo for why that matters).

    quant and qin reach the varying half's conv (conv), as in the JAX package; no caller of
    either package sets qin here. precision reaches both halves; the 2D half's kernel
    (the sum of its depth taps) is summed in fp32 first and then rounded, as in the JAX
    package.
    """
    if w.shape[2] != 3:
        raise ValueError("conv3d_mixed needs a depth kernel of 3")
    Cv = varying.shape[-1]
    D = varying.shape[1]
    if stride not in (1, 2) or D % stride:
        raise ValueError(f"conv3d_mixed supports stride 1, or 2 on even D; got {stride}, D={D}")
    wc = w[:, Cv:]
    y = conv(varying, w[:, :Cv], stride=stride, split=split, quant=quant,
             qin=qin, precision=precision)                       # (B, D', h', w', Cout)

    def conv2(taps):
        return conv(const2d, sum(wc[:, :, t] for t in taps), stride=stride, precision=precision)

    mid = conv2((0, 1, 2))[:, None]
    Do = D // stride
    # SAME pads D by (1, 1) at stride 1: the first plane misses tap 0, the last tap 2; by
    # (0, 1) at stride 2: only the last output misses tap 2
    if split is None:
        head = [conv2((1, 2))[:, None]] if stride == 1 else []
        parts = head + [mid.expand(-1, Do - len(head) - 1, -1, -1, -1), conv2((0, 1))[:, None]]
        return y + torch.cat(parts, dim=1)
    shape = (1, Do, 1, 1, 1)
    first = torch.zeros(shape, dtype=y.dtype, device=y.device)
    last = torch.zeros(shape, dtype=y.dtype, device=y.device)
    if stride == 1 and split.is_first:
        first[:, 0] = 1
    if split.is_last:
        last[:, -1] = 1
    return y + (mid - first * conv2((0,))[:, None] - last * conv2((2,))[:, None])


def conv3d_mixed_bn(w: torch.Tensor, varying: torch.Tensor, const2d: torch.Tensor,
                    stride: int = 1, relu: bool = True, eps: float = 1e-3,
                    quant: Optional[ActQuant] = None, split=None,
                    qin: bool = False, precision: str = "highest") -> torch.Tensor:
    y = batch_stat_norm(conv3d_mixed(w, varying, const2d, stride=stride, split=split,
                                     quant=quant, qin=qin, precision=precision),
                        eps=eps, split=split)
    return quantize_act(activate(y) if relu else y, quant, nonneg=relu, split=split)


# ---------------------------------------------------------------------------
# parameter holders: names mirror the JAX tree ('w', 'b', 'beta'); kernels are kept
# in PyTorch's layout and initialised like the JAX package (truncated Glorot normal)
# ---------------------------------------------------------------------------


def glorot_normal(tf_shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated (+-2 sd) Glorot normal over a TF-layout shape (spatial..., in, out),
    returned in PyTorch's kernel layout (out, in, spatial...)."""
    receptive = math.prod(tf_shape[:-2]) if len(tf_shape) > 2 else 1
    std = math.sqrt(2.0 / ((tf_shape[-2] + tf_shape[-1]) * receptive))
    t = torch.empty(tf_shape, dtype=torch.float32)
    tnn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=generator)
    return tf_to_torch(t * std)


def tf_to_torch(w: torch.Tensor) -> torch.Tensor:
    """TF kernel (k..., a, b) -> PyTorch (b, a, k...).

    One permutation serves both kinds: a conv kernel (k..., in, out) becomes
    (out, in, k...), and a transpose-conv kernel (k..., out, in) becomes conv_transpose's
    (in, out, k...)."""
    nd = w.ndim - 2
    return w.permute(nd + 1, nd, *range(nd)).contiguous()


def torch_to_tf(w: torch.Tensor) -> torch.Tensor:
    """Inverse of tf_to_torch."""
    nd = w.ndim - 2
    return w.permute(*range(2, nd + 2), 1, 0).contiguous()


class Conv(tnn.Module):
    """Kernel `w` (+ bias `b`) of a conv; `w` is (out, in, k...)."""

    def __init__(self, k: int, cin: int, cout: int, nd: int = 2, biased: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = tnn.Parameter(glorot_normal((k,) * nd + (cin, cout), generator))
        self.b = tnn.Parameter(torch.zeros(cout)) if biased else None


class Deconv(tnn.Module):
    """Kernel `w` of a transpose conv, (in, out, k...)."""

    def __init__(self, k: int, cin: int, cout: int, nd: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = tnn.Parameter(glorot_normal((k,) * nd + (cout, cin), generator))
