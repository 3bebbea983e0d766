"""The whole forward's share of the card's TF32 tensor-core peak over the traced window
(fp32_precision "default", whose convs run there): the analytic FLOPs of a map
(benchmark.flops) times the maps completed, over the window's seconds, over 494.7 TFLOP/s,
the dense TF32 peak of the H100 SXM part (378 for the PCIe part;
benchmark.roofline_tf32.TF32_FLOP_PER_S)."""

from benchmark import roofline
from benchmark.metrics.common import traced
from benchmark.roofline_tf32 import TF32_FLOP_PER_S


def read(run):
    if not traced(run) or run.device.type != "cuda":
        return None
    import torch

    peak = TF32_FLOP_PER_S[roofline.part(torch.cuda.get_device_name(run.device))]
    return 100.0 * run.flops_traced / run.trace.window_s / peak
