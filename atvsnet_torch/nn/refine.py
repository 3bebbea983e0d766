"""CostVolRefineNet: geometry-aware cost volume refinement 3D U-Net (atvsnet_tpu/nn/refine.py;
reference cnn_wrapper/atvsnet.py:295-336).

Four input groups (photometric, geometric, probability volume, visual hull), each
conv_bn'd to base_filter channels and concatenated, then one U-Net block with skip
additions. Outputs the cost residual ('global_refine_3dconv6_1') and the 1-channel
prob residual ('global_refined_cost_vol').
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as tnn

from atvsnet_torch.nn import layers as L

_P = "global_refine"


class RefineNet(tnn.Module):
    def __init__(self, photo_ch: int, geo_ch: int, base_filter: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = base_filter, generator
        convs = {
            "_photo_3dconv": (photo_ch, f), "_geo_3dconv": (geo_ch, f),
            "_prob_3dconv": (1, f), "_vishull_3dconv": (1, f),
            "_3dconv1_0": (4 * f, 2 * f), "_3dconv2_0": (2 * f, 4 * f),
            "_3dconv3_0": (4 * f, 8 * f), "_3dconv0_1": (4 * f, f),
            "_3dconv1_1": (2 * f, 2 * f), "_3dconv2_1": (4 * f, 4 * f),
            "_3dconv3_1": (8 * f, 8 * f),
        }
        for name, (cin, cout) in convs.items():
            self.add_module(_P + name, L.Conv(3, cin, cout, nd=3, generator=g))
        deconvs = {"_3dconv4_0": (8 * f, 4 * f), "_3dconv5_0": (4 * f, 2 * f),
                   "_3dconv6_0": (2 * f, f)}
        for name, (cin, cout) in deconvs.items():
            self.add_module(_P + name, L.Deconv(3, cin, cout, nd=3, generator=g))
        self.add_module(_P + "d_cost_vol", L.Conv(3, f, 1, nd=3, generator=g))

    def _w(self, name: str) -> torch.Tensor:
        return getattr(self, _P + name).w

    def forward(self, photo_group, geo_group, prob_vol: torch.Tensor,
                vis_hull: torch.Tensor, eps: float = 1e-3, quant: Optional[L.ActQuant] = None,
                split=None, precision: str = "highest"):
        """All inputs (B, D, h, w, *) -> (cost_residual (B,D,h,w,f), prob_residual (B,D,h,w)).

        Structured (broadcast-free) groups, exact equivalents of the reference concats:
          photo_group = (varying (B,D,h,w,F), const2d (B,h,w,2F));
          geo_group = (varying (B,D,h,w,2), const2d (B,h,w,2), F): the geometric view
            term is one channel broadcast to F in the reference, so the kernel collapses
            over those F in-channels.
        quant and split as in CRM.forward: every bn link, the four entries included, is
        quantized (the JAX package quantizes its hand-written geo entry too). Under
        "int8mxu" the seven trunk convs and d_cost_vol run on int8 operands (qin): they
        read the concat or sums of stored links; the four entries read the raw groups.
        precision (PipelineConfig.fp32_precision) as in CRM.forward.
        """

        def cbn(name, x, stride=1, qin=True):
            return L.conv_bn(x, self._w(name), stride=stride, eps=eps, quant=quant, split=split,
                             qin=qin, precision=precision)

        def dbn(name, x):
            return L.deconv_bn(x, self._w(name), stride=2, eps=eps, quant=quant, split=split,
                               precision=precision)

        def mixed(w, vary, const2d):
            return L.conv3d_mixed_bn(w, vary, const2d, eps=eps, quant=quant, split=split,
                                     precision=precision)

        vary, const2d = photo_group
        photo = mixed(self._w("_photo_3dconv"), vary, const2d)

        vary, const2d, F = geo_group
        # in-channels [geo_ref(1), geo_view(F), geo_err(1), ref_depth(1)]
        w = self._w("_geo_3dconv")
        w_eff = torch.cat([w[:, 0:1], w[:, 1:1 + F].sum(dim=1, keepdim=True), w[:, 1 + F:]], dim=1)
        geo = mixed(w_eff, vary, const2d)

        x = torch.cat([photo, geo, cbn("_prob_3dconv", prob_vol, qin=False),
                       cbn("_vishull_3dconv", vis_hull, qin=False)], dim=-1)
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
        c6_1 = c6_0 + c0_1  # cost residual (B, D, h, w, f)
        return c6_1, L.conv(c6_1, self._w("d_cost_vol"), split=split, quant=quant, qin=True,
                            precision=precision)[..., 0]
