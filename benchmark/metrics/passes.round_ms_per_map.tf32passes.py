"""Device ms per map in the operand rounding of fp32_precision "default": the time between
the CUDA events of every `passes.round` span (a pass leaf's bf16 rounding of its two
operands, ops.fp32_passes) in the traced window, summed, over the maps traced. None where
the window holds no such spans (a program without them) or where one lacks its device
time."""

from benchmark.metrics.spans import stage_ms_per_map


def read(run):
    return stage_ms_per_map(run, "passes.round")
