"""Pre-activation bottleneck residual units (atvsnet_tpu/nn/blocks.py; reference network.py:552-616).

slim-default semantics: preact = relu(BN_center(x)); conv1 = relu(1x1 + bias);
conv2 = relu(kxk dilated + bias), fixed padding when strided; conv3 = 1x1 + bias;
shortcut = identity / 1x1 max-pool / 1x1 conv of preact with bias. `precision` is
PipelineConfig.fp32_precision, passed to every conv (nn.layers).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from atvsnet_torch.nn import layers as L


class Preact(tnn.Module):
    """Centering offset `beta` of the pre-activation batch norm."""

    def __init__(self, cin: int):
        super().__init__()
        self.beta = tnn.Parameter(torch.zeros(cin))


class Bottleneck(tnn.Module):
    def __init__(self, cin: int, depth: int, k: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.preact = Preact(cin)
        self.conv1 = L.Conv(1, cin, depth, biased=True, generator=generator)
        self.conv2 = L.Conv(k, depth, depth, biased=True, generator=generator)
        self.conv3 = L.Conv(1, depth, depth, biased=True, generator=generator)
        self.shortcut = (L.Conv(1, cin, depth, biased=True, generator=generator)
                         if depth != cin else None)

    def forward(self, x: torch.Tensor, stride: int = 1, rate: int = 1,
                eps: float = 1e-3, precision: str = "highest") -> torch.Tensor:
        p = precision
        preact = L.activate(L.batch_stat_norm(x, eps=eps, beta=self.preact.beta))
        if self.shortcut is not None:
            shortcut = L.conv(preact, self.shortcut.w, self.shortcut.b, stride=stride, precision=p)
        elif stride == 1:
            shortcut = x
        else:
            shortcut = L.max_pool_same(x, 1, stride)
        residual = L.conv(preact, self.conv1.w, self.conv1.b, relu=True, precision=p)
        if stride == 1:
            residual = L.conv(residual, self.conv2.w, self.conv2.b, rate=rate, relu=True,
                              precision=p)
        else:
            residual = L.fixed_pad_conv(residual, self.conv2.w, self.conv2.b,
                                        stride=stride, rate=rate, relu=True, precision=p)
        return shortcut + L.conv(residual, self.conv3.w, self.conv3.b, precision=p)


def res_block_names(name: str, num_block: int) -> list[str]:
    """Scope names used by the reference (network.py:604-616): name_0, ..., name."""
    if num_block == 1:
        return [name]
    return [f"{name}_{i}" for i in range(num_block - 1)] + [name]


def add_res_block(parent: tnn.Module, name: str, cin: int, depth: int, num_block: int,
                  k: int = 3, generator: Optional[torch.Generator] = None) -> None:
    """Register the block's bottlenecks on `parent` under the reference's names."""
    c = cin
    for sub in res_block_names(name, num_block):
        parent.add_module(sub, Bottleneck(c, depth, k, generator))
        c = depth


def res_block(parent: tnn.Module, x: torch.Tensor, name: str, num_block: int,
              stride: int = 1, rate: int = 1, eps: float = 1e-3,
              precision: str = "highest") -> torch.Tensor:
    names = res_block_names(name, num_block)
    y = getattr(parent, names[0])(x, stride=stride, rate=rate, eps=eps, precision=precision)
    for sub in names[1:]:
        y = getattr(parent, sub)(y, stride=1, rate=rate, eps=eps, precision=precision)
    return y
