"""Cost regularization module (atvsnet_tpu/nn/crm.py): a stacked 3D U-Net over the
plane-sweep volume (reference StackedUNet_prob, cnn_wrapper/atvsnet.py:100-192).

Three U-Net blocks over (B, D, h, w, C) with dense skip additions between blocks; the
prob head is a 3x3x3 conv to 1 channel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from atvsnet_torch.nn import layers as L


def _unet_block_names(b: int) -> list[tuple[str, str, int, int]]:
    """(name, kind, out_ch_multiple, stride) in execution order for block index b."""
    return [
        (f"conv_b{b}_1_0", "conv", 2, 2),
        (f"conv_b{b}_2_0", "conv", 4, 2),
        (f"conv_b{b}_3_0", "conv", 8, 2),
        (f"conv_b{b}_0_1", "conv", 1, 1),
        (f"conv_b{b}_1_1", "conv", 2, 1),
        (f"conv_b{b}_2_1", "conv", 4, 1),
        (f"conv_b{b}_3_1", "conv", 8, 1),
        (f"conv_b{b}_4_0", "deconv", 4, 2),
        (f"conv_b{b}_5_0", "deconv", 2, 2),
        (f"conv_b{b}_6_0", "deconv", 1, 2),
    ]


class CRM(tnn.Module):
    def __init__(self, in_channels: int, base_filter: int = 8, prob_output: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = base_filter
        for b in range(3):
            cin0 = in_channels if b == 0 else f
            for name, kind, mult, _stride in _unet_block_names(b):
                cout = f * mult
                if kind == "conv":
                    cin = {"1_0": cin0, "2_0": f * 2, "3_0": f * 4, "0_1": cin0}.get(name[-3:], cout)
                    self.add_module(name, L.Conv(3, cin, cout, nd=3, generator=generator))
                else:
                    cin = f * 8 if name.endswith("_4_0") else cout * 2
                    self.add_module(name, L.Deconv(3, cin, cout, nd=3, generator=generator))
        self.conv_b2_6_2 = L.Conv(3, f, 1, nd=3, generator=generator) if prob_output else None

    def forward(self, cost_volume, eps: float = 1e-3, quant: Optional[L.ActQuant] = None,
                split=None, precision: str = "highest"):
        """(B, D, h, w, C) -> (filtered cost (B, D, h, w, f), prob (B, D, h, w) or None).

        `cost_volume` may be a (warped (B, D, h, w, Cv), ref_feature (B, h, w, Cc)) tuple:
        the reference volume is concat(tile_D(ref_feature), warped), whose D-constant
        half enters the two input convs as 2D convs (layers.conv3d_mixed).

        quant: every conv_bn / deconv_bn link is stored on an int8 lattice (the mixed
        entry convs too, as the JAX package's closure quantizes them). Under "int8mxu" the
        trunk convs and the prob conv run on int8 operands (qin, as in the JAX package):
        their inputs are stored links or sums of two or three of them; only the two block-0
        entry convs see the raw cost volume. split: D holds this rank's planes of a 'depth'
        mesh axis (parallel.depth), at every level. precision: PipelineConfig.fp32_precision,
        for every conv and transposed conv.
        """

        def cbn(name, x, stride=1, qin=True):
            return L.conv_bn(x, getattr(self, name).w, stride=stride, eps=eps, quant=quant,
                             split=split, qin=qin, precision=precision)

        def dbn(name, x):
            return L.deconv_bn(x, getattr(self, name).w, stride=2, eps=eps, quant=quant,
                               split=split, precision=precision)

        # --- block 0 ---
        if isinstance(cost_volume, tuple):
            warped, ref2d = cost_volume
            Cc = ref2d.shape[-1]

            def mixed(name, stride):
                w = getattr(self, name).w
                # kernel in-channel order is [ref_tile, warped] (the reference's concat)
                reordered = torch.cat([w[:, Cc:], w[:, :Cc]], dim=1)
                return L.conv3d_mixed_bn(reordered, warped, ref2d, stride=stride, eps=eps,
                                         quant=quant, split=split, precision=precision)

            b0_1_0 = mixed("conv_b0_1_0", 2)
            b0_0_1 = mixed("conv_b0_0_1", 1)
        else:
            b0_1_0 = cbn("conv_b0_1_0", cost_volume, 2, qin=False)
            b0_0_1 = cbn("conv_b0_0_1", cost_volume, qin=False)
        b0_2_0 = cbn("conv_b0_2_0", b0_1_0, 2)
        b0_3_0 = cbn("conv_b0_3_0", b0_2_0, 2)
        b0_1_1 = cbn("conv_b0_1_1", b0_1_0)
        b0_2_1 = cbn("conv_b0_2_1", b0_2_0)
        b0_3_1 = cbn("conv_b0_3_1", b0_3_0)
        b0_4_0 = dbn("conv_b0_4_0", b0_3_1)
        b0_5_0 = dbn("conv_b0_5_0", b0_4_0 + b0_2_1)
        b0_6_0 = dbn("conv_b0_6_0", b0_5_0 + b0_1_1)

        # --- block 1 (dense skips from block 0) ---
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

        # --- block 2 ---
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
        b2_6_1 = b2_6_0 + b2_0_1  # filtered cost volume, (B, D, h, w, f)

        if self.conv_b2_6_2 is None:
            return b2_6_1, None
        prob = L.conv(b2_6_1, self.conv_b2_6_2.w, split=split, quant=quant, qin=True,
                      precision=precision)
        return b2_6_1, prob[..., 0]  # no relu, no bias
