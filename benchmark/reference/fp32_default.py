"""The A-TVSNet forward under fp32_precision="default", in plain PyTorch: the yardstick of
the one-pass arithmetic.

The JAX package maps fp32_precision to lax.Precision for every conv and matmul leaf with a
float32 operand (atvsnet_tpu/nn/layers.py:39-53, `_precision_for`); "default" is
Precision.DEFAULT, which on a TPU multiplies bf16(a) by bf16(b) and sums the products in
fp32. This file runs reference.model's forward unchanged, with its two convolution leaves,
`_CONV` (every 2D and 3D conv) and `_CONV_T` (every transposed conv), given operands rounded
to bf16 (to nearest, ties to even) and held as float32. A product of two bf16 values is exact
in float32, so a float32 conv with TF32 off (set on entry, restored on return) computes the
mode's products exactly and sums them in fp32. A bias is added unrounded, in fp32, as the
JAX package adds it after the conv.

The sites, with the JAX package's file and line:

  - every 2D conv: `_conv2d` (atvsnet_tpu/nn/layers.py:57-70, precision at :68): the FEM's
    and the shallow FEM's convs with their biases, the SPP branches, fusion0 and fusion1,
    and the 2D halves of conv3d_mixed (CRM's two entries, the refinement's photo and geo
    entries), whose kernel is the sum of its depth taps, summed in fp32 and then rounded,
    as the JAX package's conv3d_mixed (layers.py:627-668) hands the summed kernel to conv;
  - every strided conv with fixed padding: `fixed_pad_conv` (layers.py:258-284, :280);
  - every 3D conv: `conv` (layers.py:209-255, :251, and its depth-tap forms, which call
    `_conv2d` on the same values): CRM's trunk and prob convs, the refinement's four
    entries, trunk and d_cost_vol, AAM's [unique | shared] and output convs; the geo entry's
    kernel is collapsed over its F identical in-channels before rounding, as the JAX package
    collapses it (atvsnet_tpu/nn/refine.py:85-95);
  - every transposed 3D conv: `deconv` (layers.py:482-513), the vjp of the strided conv,
    to which XLA's transpose rule carries the conv's precision: its products are bf16(x)
    times bf16(w) taps, as aten's conv_transpose3d computes them here.

Not rounded, as the JAX package leaves them at full fp32: the forward has no matmul leaf
(the SPP resize and the upsampled soft-argmin's interpolation matmuls run at HIGHEST,
atvsnet_tpu/geometry/depth_regression.py:53-54, :171, :178; so do the homographies and the
warps' projections, geometry/homography.py:27, geometry/warp.py:32); the batch-statistic
norms, the soft-argmins, the sampling and every elementwise op are fp32.

Departures: none in the mathematics. The fp32 sums of the exact products run in cuDNN's
order here and in the program's (the TF32 tensor cores') order there, so the two differ by
fp32 rounding, and where that noise moves a value across a bf16 rounding tie before the next
leaf, that leaf's operand moves by a bf16 step: the sound runs' gaps (PERF.md section 2).
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """The float32 values of bf16(t), rounded to nearest, ties to even."""
    return t.to(torch.bfloat16).to(torch.float32)


def _one_pass(leaf):
    """A conv leaf of reference.model whose two operands are rounded to bf16 first."""
    def rounded(x, w, *args, **kw):
        return leaf(bf16_round(x), bf16_round(w), *args, **kw)

    return rounded


class one_pass_leaves:
    """reference.model's conv and transposed-conv leaves on bf16-rounded operands, with TF32
    off, for the body of a `with`; the leaves and both TF32 flags read as before
    afterwards."""

    def __enter__(self):
        self.saved = dict(M._CONV), dict(M._CONV_T)
        self.flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        M._CONV.update({nd: _one_pass(f) for nd, f in self.saved[0].items()})
        M._CONV_T.update({nd: _one_pass(f) for nd, f in self.saved[1].items()})

    def __exit__(self, *exc):
        M._CONV.update(self.saved[0])
        M._CONV_T.update(self.saved[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags
        return False


@torch.no_grad()
def forward(p, images, cams, D, upsample=True, eps=1e-3):
    """reference.model.forward in the one-pass arithmetic: the same inputs and outputs."""
    with one_pass_leaves():
        return M.forward(p, images, cams, D, upsample=upsample, eps=eps)
