"""Attention aggregation module over view pairs (atvsnet_tpu/nn/aam.py; reference
cnn_wrapper/network.py:282-408).

For each view slice x_i, with a per-view UNIQUE kernel and a SHARED kernel,

    a_i = relu(conv3d(x_i, W_unique)) - relu(conv3d(x_i, W_shared))
          + sum_j relu(conv3d(x_j, W_shared))

then score = softmax over views of a (in fp32) and output = sum_i score_i * x_i.

With the pairs split over the ranks of a 'view' group (parallel.mesh), every sum over
views is a local sum followed by an all-reduce over the group: the shared-weight sum,
the softmax's max and normaliser, and the weighted sum. Those that carry gradient go
through torch.distributed.nn's all-reduce, whose backward all-reduces the gradient.
With the D planes split over a 'depth' group (parallel.depth), the two 3x3x3 convs
exchange halos; the softmax over views is per plane and needs no collective over D.

`quant` (nn.layers.ActQuant): under "int8mxu" the [unique | shared] conv and the output
conv run on int8 operands (qin, as in the JAX package): their inputs are the CRM's or the
refinement's output volumes, sums of two stored links, and the softmax-convex mix of them.
`precision` (PipelineConfig.fp32_precision) reaches every conv (nn.layers).

The pipeline aggregates the view-leading stack (attention_aggregate_stacked). The
view-trailing (B, D, h, w, C, N) forms (attention_activation, attention_aggregate) and
the 2D variant (Attention2D, attention_activation_2d) are the JAX package's public
helpers, which no path of either package calls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as tnn

from atvsnet_torch.nn import layers as L
from atvsnet_torch.parallel.mesh import all_reduce_sum


class Attention(tnn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (kernel_size,) * 3 + (channels, channels)
        self.weight_unique = tnn.Parameter(L.glorot_normal(shape, generator))
        self.weight_shared = tnn.Parameter(L.glorot_normal(shape, generator))


class Attention2D(tnn.Module):
    """The 2D variant's weights (init_attention_2d): weight_unique and weight_shared, TF
    (k, k, C, C) kernels held as (C, C, k, k)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (kernel_size,) * 2 + (channels, channels)
        self.weight_unique = tnn.Parameter(L.glorot_normal(shape, generator))
        self.weight_shared = tnn.Parameter(L.glorot_normal(shape, generator))


class OutputConv(tnn.Module):
    """3x3x3 conv to 1 channel, no relu or bias, registered under `name`."""

    def __init__(self, name: str, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_module(name, L.Conv(3, channels, 1, nd=3, generator=generator))


def _unique_shared(att: Attention, x: torch.Tensor, split=None,
                   quant: Optional[L.ActQuant] = None, precision: str = "highest"):
    """relu(conv3d(x_i, W_unique)) and relu(conv3d(x_i, W_shared)) of every view of the
    view-leading stack x (N, B, D, h, w, C), each shaped as x."""
    N, B, C = x.shape[0], x.shape[1], x.shape[-1]
    xv = x.reshape((N * B,) + x.shape[2:])
    # [unique | shared] stacked on the output-channel axis: one conv for both
    w_cat = torch.cat([att.weight_unique, att.weight_shared], dim=0)
    both = L.conv(xv, w_cat, relu=True, split=split, quant=quant, qin=True, precision=precision)
    both = both.reshape(x.shape[:-1] + (2 * C,))
    return both[..., :C], both[..., C:]


def attention_activation(att: Attention, x: torch.Tensor,
                         quant: Optional[L.ActQuant] = None,
                         precision: str = "highest") -> torch.Tensor:
    """View-trailing stack (B, D, h, w, C, N) -> the per-view activations a_i, (B, D, h, w,
    C, N)."""
    unique, shared = _unique_shared(att, x.movedim(-1, 0), quant=quant, precision=precision)
    return (unique - shared + shared.sum(dim=0, keepdim=True)).movedim(0, -1)


def attention_aggregate(att: Attention, x: torch.Tensor,
                        quant: Optional[L.ActQuant] = None,
                        precision: str = "highest") -> torch.Tensor:
    """View-trailing stack (B, D, h, w, C, N) -> (B, D, h, w, C): the fp32 softmax over
    views of the activations weights the views' sum."""
    score = torch.softmax(attention_activation(att, x, quant, precision).to(torch.float32),
                          dim=-1)
    return torch.sum(score.to(x.dtype) * x, dim=-1)


def attention_activation_2d(att: Attention2D, x: torch.Tensor,
                            precision: str = "highest") -> torch.Tensor:
    """2D variant over (B, H, W, C, N) stacks (reference network.py:411-478): two 2D convs
    with relu, one per weight."""
    B, H, W, C, N = x.shape
    xv = x.movedim(-1, 0).reshape(N * B, H, W, C)
    unique = L.conv(xv, att.weight_unique, relu=True, precision=precision).reshape(N, B, H, W, C)
    shared = L.conv(xv, att.weight_shared, relu=True, precision=precision).reshape(N, B, H, W, C)
    return (unique - shared + shared.sum(dim=0, keepdim=True)).movedim(0, -1)


def attention_aggregate_stacked(att: Attention, x: torch.Tensor,
                                group: Optional[dist.ProcessGroup] = None,
                                split=None, quant: Optional[L.ActQuant] = None,
                                precision: str = "highest") -> torch.Tensor:
    """View-leading stack (N, B, D, h, w, C) -> (B, D, h, w, C).

    With a `group`, x holds this rank's views and the result is over the group's views.
    With a depth `split`, D holds this rank's planes.
    """
    unique, shared = _unique_shared(att, x, split, quant, precision)
    if group is None:
        act = (unique - shared + shared.sum(dim=0, keepdim=True)).to(torch.float32)
        score = torch.softmax(act, dim=0)
        return torch.sum(score.to(x.dtype) * x, dim=0)
    # the sums accumulate in fp32 and round once, as the local ones above do
    f32 = torch.float32
    shared_sum = all_reduce_sum(shared.sum(dim=0, keepdim=True, dtype=f32), group)
    act = (unique - shared + shared_sum.to(shared.dtype)).to(f32)
    # the max only steadies the exponent: the softmax does not depend on it
    m = act.detach().amax(dim=0, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(act - m)
    score = e / all_reduce_sum(e.sum(dim=0, keepdim=True), group)
    return all_reduce_sum(torch.sum(score.to(x.dtype) * x, dim=0, dtype=f32), group).to(x.dtype)


def output_conv(module: OutputConv, name: str, cost_volume: torch.Tensor,
                split=None, quant: Optional[L.ActQuant] = None,
                precision: str = "highest") -> torch.Tensor:
    """(B, D, h, w, C) -> (B, D, h, w)."""
    return L.conv(cost_volume, getattr(module, name).w, split=split, quant=quant,
                  qin=True, precision=precision)[..., 0]
