"""The least time of a pass leaf of fp32_precision "high" or "default" (ops.fp32_passes):
a conv, transposed conv or matmul on bf16-rounded float32 operands, on the TF32 tensor
cores.

One leaf's forward call, by the key of the program's launch counts (ops.fp32_passes
`pass_conv` / `pass_conv_transpose` / `pass_matmul` `.shape_launches`: kind, the shapes of
the two operands as the leaf takes them, stride, padding, dilation, groups, mode). Its
operands read once and its output written once, 4 bytes a value (the rounded operands are
held as float32), over the HBM bandwidth; against 2 operations a multiply-add, times the
mode's passes (1 for "default"; 3 for "high": a_hi*b_hi, a_hi*b_lo and a_lo*b_hi), over the
TF32 tensor cores' dense peak (NVIDIA's data sheet: 989 TFLOP/s sparse for the SXM part and
756 for the PCIe part, so 494.7 and 378 dense); the larger of the two.

Kinds: "conv2d" / "conv3d", x (B, Ci, *S), w (Co, Ci / groups, *k), aten's symmetric
padding; "conv_transpose", x (B, Ci, *S), w (Ci, Co / groups, *k); "matmul", a (..., K),
b (K, N).
"""

from __future__ import annotations

import math

from benchmark.roofline import PEAKS

TF32_FLOP_PER_S = {"sxm": 494.7e12, "pcie": 378e12}
PASSES = {"default": 1, "high": 3}


def leaf_work(key) -> tuple[int, int]:
    """(multiply-adds of one pass, bytes moved) of one leaf call."""
    kind, a, b, stride, padding, dilation, groups, _ = key
    if kind == "matmul":
        m = math.prod(a[:-1])
        return m * a[-1] * b[1], 4 * (math.prod(a) + math.prod(b) + m * b[1])
    batch, cin, spatial, taps = a[0], a[1], a[2:], b[2:]
    if kind == "conv_transpose":
        cout = b[1] * groups
        out = [(n - 1) * s - 2 * p + d * (k - 1) + 1
               for n, s, p, d, k in zip(spatial, stride, padding, dilation, taps)]
        macs = batch * math.prod(spatial) * cin * b[1] * math.prod(taps)
    else:
        cout = b[0]
        out = [(n + 2 * p - d * (k - 1) - 1) // s + 1
               for n, s, p, d, k in zip(spatial, stride, padding, dilation, taps)]
        macs = batch * cout * math.prod(out) * b[1] * math.prod(taps)
    return macs, 4 * (math.prod(a) + math.prod(b) + batch * cout * math.prod(out))


def leaf_bound_s(key, kind: str = "sxm") -> tuple[float, str]:
    """Least seconds of one leaf call and which bound sets it ("bytes" or "operations")."""
    macs, nbytes = leaf_work(key)
    t_bytes = nbytes / PEAKS[kind]["hbm_bytes_per_s"]
    t_ops = 2 * macs * PASSES[key[-1]] / TF32_FLOP_PER_S[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
