"""PipelineConfig.fp32_precision: the TPU's bf16 pass arithmetic for the convolutions and
matmuls whose operands are float32, forward and backward, on Hopper's TF32 tensor cores.

The JAX package maps the mode to lax.Precision for every conv and matmul leaf with a
float32 operand (atvsnet_tpu/nn/layers.py:39-53); on a TPU the MXU then multiplies bf16
pieces of the operands and sums in fp32:

  highest  full fp32 (six passes);
  high     a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, with a_hi = bf16(a), a_lo = bf16(a - a_hi),
           fp32 sums (three passes);
  default  bf16(a)*bf16(b), fp32 sums (one pass).

Rounding is to nearest, ties to even, and the results are float32. XLA's transpose rules
carry the precision to both transposed convolutions, so a gradient is the same arithmetic
on its own two operands: grad_input splits (cotangent, weight), grad_weight splits (input,
cotangent).

Why the tensor cores compute it exactly: a bf16 value has 7 explicit mantissa bits, so it
is exact in TF32 (10), and the product of two of them is exact in fp32. A cuDNN conv or a
cuBLAS matmul with TF32 allowed, run on pre-rounded operands, sums exact products in fp32:
the mode's arithmetic, up to the order of the fp32 sums. "high" runs as two such calls
summed in fp32: a_hi*b_hi alone, and the two small passes as one call on operands
concatenated along the contracted axis, [a_hi | a_lo] against [b_lo | b_hi] (the input
channels of a forward conv, the output channels of its grad_input, the batch of its
grad_weight, K of a matmul). The tensor cores' fp32 sums are noisier than the CUDA cores'
(on an H100 about 3x the TF32-off call's error over the same length); one call over all
three passes triples the length of the big pass's sums and measured above the leaf bound
(PERF.md §6), two calls keep it as long as "default"'s. A grouped conv's forward and
grad_input take three calls. Plain TF32 (10-bit operands, torch's own "high") is neither
mode.

Each call scopes the TF32 flags (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32): on for "high" and "default", off for "highest";
they read as before when the call returns, and the backward enters its own scope, since
autograd runs outside the forward's. On the CPU there is no TF32: the same operands run
through fp32 convs and matmuls, which is the mode's arithmetic itself.

  * `pass_conv`, `pass_conv_transpose`, `pass_matmul`: the leaves, each behind a
    torch.autograd.Function whose backward computes both gradients in the mode;
  * `conv_plain`, `matmul_plain`: the same arithmetic evaluated in float64 from the same
    fp32 pieces (three float64 calls for "high"), the plain versions that tests and
    chip_smoke.py hold the leaves to; `conv_exact`, `matmul_exact`: the float64 product of
    the unrounded operands or, with magnitude=True, of their absolute values, whose largest
    value (max sum |a||b|) is the scale of a leaf's error.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from atvsnet_torch.config import FP32_PRECISION_MODES

_F32 = torch.float32


def check_mode(mode: str) -> str:
    if mode not in FP32_PRECISION_MODES:
        raise ValueError(f"fp32_precision={mode!r}: expected one of "
                         f"{'|'.join(FP32_PRECISION_MODES)}")
    return mode


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """The float32 values of bf16(a), rounded to nearest, ties to even."""
    return a.to(torch.bfloat16).to(_F32)


def bf16_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a_hi, a_lo) = (bf16(a), bf16(a - a_hi)) as float32 values."""
    hi = bf16_round(a)
    return hi, bf16_round(a - hi)


@contextlib.contextmanager
def tf32(allowed: bool):
    """TF32 for cuDNN convolutions and CUDA matmuls on or off for the body; both flags read
    as before afterwards."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _passes(op: Callable, a: torch.Tensor, b: torch.Tensor, mode: str,
            cat: Optional[tuple[int, int]] = None, exact: bool = False,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """op(a, b), a bilinear op, in the mode's arithmetic, plus `bias` where op takes one
    (op(a, b, bias): added in fp32 by the first call). cat: the contracted axis of a and of
    b, along which "high"'s two small passes concatenate into one op (None: three ops
    summed in fp32). exact: the pieces are float32 as always, the op runs in float64 (the
    plain version)."""
    def run(x, y, c=None):
        if exact:
            x, y, c = x.double(), y.double(), None if c is None else c.double()
        return op(x, y) if c is None else op(x, y, c)

    if mode == "highest":
        return run(a, b, bias)
    if mode == "default":
        return run(bf16_round(a), bf16_round(b), bias)
    (ah, al), (bh, bl) = bf16_split(a), bf16_split(b)
    if cat is not None and not exact:
        return run(ah, bh, bias) + op(torch.cat([ah, al], dim=cat[0]),
                                      torch.cat([bl, bh], dim=cat[1]))
    return run(ah, bh, bias) + run(ah, bl) + run(al, bh)


# ---- convolutions ----

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """aten.convolution's arguments past its operands, for channel-first tensors."""

    stride: tuple
    padding: tuple
    dilation: tuple
    groups: int = 1
    transposed: bool = False

    @classmethod
    def of(cls, nd: int, stride=1, padding=0, dilation=1, groups=1, transposed=False):
        def tup(v):
            return tuple(v) if isinstance(v, Sequence) else (v,) * nd
        return cls(tup(stride), tup(padding), tup(dilation), groups, transposed)

    def _zeros(self):
        return (0,) * len(self.stride)

    def forward(self, x, w, bias=None):
        return torch.ops.aten.convolution(x, w, bias, self.stride, self.padding, self.dilation,
                                          self.transposed, self._zeros(), self.groups)

    def backward(self, x, g, w, mask, bias_sizes=None):
        """aten's own backward: (grad_input, grad_weight, grad_bias) where `mask` asks."""
        return torch.ops.aten.convolution_backward(
            g, x, w, bias_sizes, self.stride, self.padding, self.dilation, self.transposed,
            self._zeros(), self.groups, mask)

    # x of grad_input and w of grad_weight give only their shapes
    def grad_input(self, x, g, w):
        return self.backward(x.to(g.dtype), g, w, [True, False, False])[0]

    def grad_weight(self, x, g, w):
        return self.backward(x, g, w.to(g.dtype), [False, True, False])[1]

    # the contracted axes along which "high" concatenates (None: three calls)
    def forward_cat(self):
        return None if self.groups != 1 else (1, 0 if self.transposed else 1)

    def grad_input_cat(self):
        return None if self.groups != 1 else (1, 1 if self.transposed else 0)


def _conv_forward(x, w, mode, spec: ConvSpec, exact=False, bias=None):
    return _passes(spec.forward, x, w, mode, spec.forward_cat(), exact, bias)


def _conv_grad_input(x, g, w, mode, spec: ConvSpec, exact=False):
    return _passes(lambda g_, w_: spec.grad_input(x, g_, w_), g, w, mode,
                   spec.grad_input_cat(), exact)


def _conv_grad_weight(x, g, w, mode, spec: ConvSpec, exact=False):
    return _passes(lambda x_, g_: spec.grad_weight(x_, g_, w), x, g, mode, (0, 0), exact)


class _PassConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, mode, spec):
        ctx.save_for_backward(x, w)
        ctx.mode, ctx.spec = mode, spec
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        with tf32(mode != "highest"):
            return _conv_forward(x, w, mode, spec, bias=bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        spec, mode = ctx.spec, ctx.mode
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        with tf32(mode != "highest"):
            if mode == "highest":          # aten's own backward, as autograd runs it
                gx, gw, gb = spec.backward(x, g, w, [need_x, need_w, need_b], ctx.bias_sizes)
                return gx, gw, gb, None, None
            gx = _conv_grad_input(x, g, w, mode, spec) if need_x else None
            gw = _conv_grad_weight(x, g, w, mode, spec) if need_w else None
            gb = (spec.backward(x, g, w, [False, False, True], ctx.bias_sizes)[2]
                  if need_b else None)
        return gx, gw, gb, None, None


def _check_f32(name, *ts):
    if any(t.dtype != _F32 for t in ts):
        raise TypeError(f"{name} takes float32 operands, got {[t.dtype for t in ts]}")


def pass_conv(x: torch.Tensor, w: torch.Tensor, mode: str, stride=1, padding=0, dilation=1,
              groups: int = 1, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel-first conv (x (B, Ci, ...), w (Co, Ci / groups, k...)) in the mode's
    arithmetic, with symmetric `padding` and an fp32 `bias` added in the call, as the port's
    "highest" always added it; gradients to x and w in the same mode. "highest" is aten's
    convolution and its own backward, with TF32 off."""
    _check_f32("pass_conv", x, w)
    spec = ConvSpec.of(x.ndim - 2, stride, padding, dilation, groups)
    return _PassConv.apply(x, w, bias, check_mode(mode), spec)


def pass_conv_transpose(x: torch.Tensor, w: torch.Tensor, mode: str, stride=1) -> torch.Tensor:
    """conv_transpose{2,3}d with padding 0 (w (Ci, Co, k...)) in the mode's arithmetic."""
    _check_f32("pass_conv_transpose", x, w)
    spec = ConvSpec.of(x.ndim - 2, stride, transposed=True)
    return _PassConv.apply(x, w, None, check_mode(mode), spec)


def conv_plain(x, w, mode, spec: ConvSpec, g=None) -> dict:
    """The float64 plain versions of a conv leaf: {"forward": ...} and, with a cotangent g,
    "grad_input" and "grad_weight"."""
    out = {"forward": _conv_forward(x, w, mode, spec, exact=True)}
    if g is not None:
        out["grad_input"] = _conv_grad_input(x, g, w, mode, spec, exact=True)
        out["grad_weight"] = _conv_grad_weight(x, g, w, mode, spec, exact=True)
    return out


def conv_exact(x, w, spec: ConvSpec, g=None, magnitude=False) -> dict:
    """conv_plain of the unrounded operands (the "highest" arithmetic in float64); with
    magnitude, of their absolute values: max Σ|a||b| per output is the error's scale."""
    f = torch.abs if magnitude else (lambda t: t)
    return conv_plain(f(x), f(w), "highest", spec, None if g is None else f(g))


# ---- matmul ----

def _flat(t):
    return t.reshape(-1, t.shape[-1])


def _mm_forward(a, b, mode, exact=False):
    return _passes(torch.matmul, a, b, mode, (-1, 0), exact)


def _mm_grad_a(g, b, mode, exact=False):
    return _passes(lambda g_, bt: g_ @ bt, g, b.transpose(0, 1), mode, (-1, 0), exact)


def _mm_grad_b(a, g, mode, exact=False):
    return _passes(lambda a_, g_: a_.transpose(0, 1) @ g_, _flat(a), _flat(g), mode, (0, 0),
                   exact)


class _PassMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        with tf32(mode != "highest"):
            return _mm_forward(a, b, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with tf32(ctx.mode != "highest"):
            if ctx.needs_input_grad[0]:
                ga = _mm_grad_a(g, b, ctx.mode)
            if ctx.needs_input_grad[1]:
                gb = _mm_grad_b(a, g, ctx.mode)
        return ga, gb, None


def pass_matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a (..., K) @ b (K, N) in the mode's arithmetic; gradients in the same mode."""
    _check_f32("pass_matmul", a, b)
    if b.ndim != 2:
        raise ValueError(f"pass_matmul takes a 2D right operand, got {tuple(b.shape)}")
    return _PassMatmul.apply(a, b, check_mode(mode))


def matmul_plain(a, b, mode, g=None) -> dict:
    """The float64 plain versions of a matmul leaf, as conv_plain."""
    out = {"forward": _mm_forward(a, b, mode, exact=True)}
    if g is not None:
        out["grad_input"] = _mm_grad_a(g, b, mode, exact=True)
        out["grad_weight"] = _mm_grad_b(a, g, mode, exact=True)
    return out


def matmul_exact(a, b, g=None, magnitude=False) -> dict:
    f = torch.abs if magnitude else (lambda t: t)
    return matmul_plain(f(a), f(b), "highest", None if g is None else f(g))
