"""Feature extraction modules (atvsnet_tpu/nn/fem.py).

FEM (ResNetDS2SPP, reference cnn_wrapper/atvsnet.py:254-292): 3 stem conv_bn (the
first stride 2), a resnet trunk (stride 2 in conv1_x, so 1/4 resolution overall),
dilated blocks, a 4-branch spatial pyramid pooling with align-corners upsampling, fused
to a base_filter-channel map at H/4 x W/4.

FEMShallow (ResNetDS2SPP_shallow_f16, atvsnet.py:245-251): 3 bottlenecks at stride 4
to a 16-channel feature for the refinement stage.

Both take `precision` (PipelineConfig.fp32_precision) for every conv (nn.layers).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from atvsnet_torch.geometry.depth_regression import resize_bilinear_align_corners
from atvsnet_torch.nn import layers as L
from atvsnet_torch.nn.blocks import add_res_block, res_block

_SPP_POOLS = (64, 32, 16, 8)


class FEM(tnn.Module):
    def __init__(self, base_filter: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = base_filter, generator
        self.conv0_0 = L.Conv(3, 3, f, generator=g)
        self.conv0_1 = L.Conv(3, f, f, generator=g)
        self.conv0_2 = L.Conv(3, f, f, generator=g)
        add_res_block(self, "conv0_x", f, f, 3, generator=g)
        add_res_block(self, "conv1_x", f, f * 2, 8, generator=g)
        add_res_block(self, "conv2_x", f * 2, f * 4, 3, generator=g)
        add_res_block(self, "conv3_x", f * 4, f * 4, 3, generator=g)
        for i in range(len(_SPP_POOLS)):
            self.add_module(f"branch_{i}_conv", L.Conv(3, f * 4, f, generator=g))
        concat_ch = f * 2 + f * 4 + len(_SPP_POOLS) * f  # conv1_x + conv3_x + SPP branches
        self.fusion0 = L.Conv(3, concat_ch, f * 4, generator=g)
        self.fusion1 = L.Conv(1, f * 4, f, generator=g)

    def forward(self, image: torch.Tensor, eps: float = 1e-3,
                precision: str = "highest") -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/4, W/4, base_filter)."""
        p = precision
        x = L.conv_bn(image, self.conv0_0.w, stride=2, eps=eps, precision=p)
        x = L.conv_bn(x, self.conv0_1.w, eps=eps, precision=p)
        x = L.conv_bn(x, self.conv0_2.w, eps=eps, precision=p)
        x = res_block(self, x, "conv0_x", 3, stride=1, rate=1, eps=eps, precision=p)
        c1 = res_block(self, x, "conv1_x", 8, stride=2, rate=1, eps=eps, precision=p)
        x = res_block(self, c1, "conv2_x", 3, stride=1, rate=2, eps=eps, precision=p)
        c3 = res_block(self, x, "conv3_x", 3, stride=1, rate=4, eps=eps, precision=p)

        h, w = c3.shape[1], c3.shape[2]
        branches = []
        for i, pool in enumerate(_SPP_POOLS):
            b = L.avg_pool_same(c3, pool, pool)
            b = L.conv_bn(b, getattr(self, f"branch_{i}_conv").w, eps=eps, precision=p)
            branches.append(resize_bilinear_align_corners(b, h, w))

        x = torch.cat([c1, c3] + branches, dim=-1)
        x = L.conv_bn(x, self.fusion0.w, eps=eps, precision=p)
        return L.conv(x, self.fusion1.w, precision=p)  # 1x1, no relu, no bias


class FEMShallow(tnn.Module):
    def __init__(self, base_filter: int = 16, generator: Optional[torch.Generator] = None):
        super().__init__()
        add_res_block(self, "global_refine_conv0_x", 3, base_filter, 3, generator=generator)
        self.global_refine_shallow_feature = L.Conv(1, base_filter, base_filter,
                                                    generator=generator)

    def forward(self, image: torch.Tensor, eps: float = 1e-3,
                precision: str = "highest") -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/4, W/4, base_filter)."""
        x = res_block(self, image, "global_refine_conv0_x", 3, stride=4, rate=1, eps=eps,
                      precision=precision)
        return L.conv(x, self.global_refine_shallow_feature.w, precision=precision)
