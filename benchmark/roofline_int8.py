"""The int8 conv kernel's least time (ops.int8_conv, act_quant="int8mxu"): a copy of
chip_smoke.py's `int8_bound_ms` and `INT8_OPS_PER_S`.

One launch over a (B, D, H, W, Ci) int8 input to Co channels at a stride, TF-SAME (the
output ceil(n / stride) per axis): the input and the 3x3x3 weights read once, the output
written once at out_bytes a value and the fp32 scale read, over the HBM bandwidth, against
2 * 27 * Ci operations per output value over the dense int8 tensor-core peak (NVIDIA's data
sheet: 1979 TOPS for the SXM part, 1513 for the PCIe part); the larger of the two.
"""

from __future__ import annotations

from benchmark.roofline import PEAKS

INT8_OPS_PER_S = {"sxm": 1979e12, "pcie": 1513e12}


def int8_bound_s(key, out_bytes: int = 4, kind: str = "sxm") -> tuple[float, str]:
    """Least seconds of one launch of the shape key (B, D, H, W, Ci, Co, stride), the key of
    ops.int8_conv.conv3d_int8_cuda.shape_launches, and which bound sets it ("bytes" or
    "operations")."""
    B, D, H, W, Ci, Co, stride = key
    outputs = B * -(-D // stride) * -(-H // stride) * -(-W // stride) * Co
    nbytes = B * D * H * W * Ci + Co * Ci * 27 + outputs * out_bytes + 4
    t_bytes = nbytes / PEAKS[kind]["hbm_bytes_per_s"]
    t_ops = 2 * 27 * Ci * outputs / INT8_OPS_PER_S[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
