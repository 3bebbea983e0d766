"""Peaks of the card and the soft-argmin kernel's least time.

Published peaks of one NVIDIA H100 (NVIDIA's data sheet, dense, at the full 700 W power
limit): the SXM part 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores;
the PCIe part 2.0 TB/s and 51 TFLOP/s. The configurations here state float32 with TF32
off, so 67 TFLOP/s is the peak that `mfu` divides by.

The soft-argmin's bound is a copy of chip_smoke.py's `bound_ms`: the cost volume read
once, the depth map written once, start and interval read once, over the HBM bandwidth, against 6 operations per
cost element (negate, max, subtract, exp, add, multiply-add) over the float32 peak; the
larger of the two.
"""

from __future__ import annotations

PEAKS = {
    "sxm": {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12},
    "pcie": {"hbm_bytes_per_s": 2.0e12, "fp32_flop_per_s": 51e12},
}
SOFTARGMIN_FLOPS_PER_ELEMENT = 6


def part(device_name: str) -> str:
    """'pcie' for an H100 PCIe card, else 'sxm' (an H100 80GB HBM3 is the SXM part)."""
    return "pcie" if "pcie" in device_name.lower() else "sxm"


def softargmin_bound_s(shape, elem_bytes: int = 4, kind: str = "sxm") -> tuple[float, str]:
    """Least seconds of one soft-argmin launch over a (B, D, h, w) cost volume (inference:
    no statistics written), and which bound sets it ("bytes" or "operations")."""
    B, D, h, w = shape
    nbytes = B * D * h * w * elem_bytes + B * h * w * 4 + 2 * B * 4
    t_bytes = nbytes / PEAKS[kind]["hbm_bytes_per_s"]
    t_ops = B * D * h * w * SOFTARGMIN_FLOPS_PER_ELEMENT / PEAKS[kind]["fp32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
