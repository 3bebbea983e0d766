"""The least time of a bf16 conv leaf (compute_dtype "bfloat16": nn.layers.bf16_conv, cuDNN's
conv or transposed conv on the bf16 tensor cores).

One leaf call, by the key of the program's launch counts (nn.layers.bf16_conv
.shape_launches: kind, the shapes of x and w as the leaf takes them, stride, padding,
dilation, groups; kinds "conv2d" / "conv3d", x (B, Ci, *S), w (Co, Ci / groups, *k), aten's
symmetric padding; "conv_transpose", x (B, Ci, *S), w (Ci, Co / groups, *k), padding 0). Its
operands read once and its output written once, 2 bytes a value, over the HBM bandwidth;
against 2 operations a multiply-add over the bf16 tensor cores' dense peak (NVIDIA's data
sheet: 1979 TFLOP/s sparse for the SXM part and 1513 for the PCIe part, so 989.4 and 756
dense); the larger of the two. The multiply-adds and the shapes are roofline_tf32's.
"""

from __future__ import annotations

from benchmark import roofline_tf32
from benchmark.roofline import PEAKS

BF16_FLOP_PER_S = {"sxm": 989.4e12, "pcie": 756e12}


def leaf_work(key) -> tuple[int, int]:
    """(multiply-adds, bytes moved) of one leaf call."""
    macs, fp32_bytes = roofline_tf32.leaf_work(tuple(key) + ("default",))
    return macs, fp32_bytes // 2


def leaf_bound_s(key, kind: str = "sxm") -> tuple[float, str]:
    """Least seconds of one leaf call and which bound sets it ("bytes" or "operations")."""
    macs, nbytes = leaf_work(key)
    t_bytes = nbytes / PEAKS[kind]["hbm_bytes_per_s"]
    t_ops = 2 * macs / BF16_FLOP_PER_S[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
