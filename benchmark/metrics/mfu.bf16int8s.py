"""The whole forward's share of the card's bf16 tensor-core peak over the traced window (the
bf16 speed mode, whose convs run there): the analytic FLOPs of a map (benchmark.flops)
times the maps completed, over the window's seconds, over 989.4 TFLOP/s, the dense bf16
peak of the H100 SXM part (756 for the PCIe part; benchmark.roofline_bf16.BF16_FLOP_PER_S)."""

from benchmark import roofline
from benchmark.metrics.common import traced
from benchmark.roofline_bf16 import BF16_FLOP_PER_S


def read(run):
    if not traced(run) or run.device.type != "cuda":
        return None
    import torch

    peak = BF16_FLOP_PER_S[roofline.part(torch.cuda.get_device_name(run.device))]
    return 100.0 * run.flops_traced / run.trace.window_s / peak
