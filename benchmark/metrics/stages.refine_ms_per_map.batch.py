"""Device ms per map in forward.refine: stage 3, the per-pair refinement (visual hull,
refine net): the time between the span's CUDA events, summed over the eval driver's
forwards in the traced window, over the maps traced."""

from benchmark.metrics.spans import stage_ms_per_map


def read(run):
    return stage_ms_per_map(run, "forward.refine")
