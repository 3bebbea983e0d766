"""Device ms per map in forward.pairs: stage 1, the per-pair base nets (cost volume, CRM
both ways, soft-argmin) and their stacks: the time between the span's CUDA events, summed
over the served requests' forwards in the traced window, over the maps traced."""

from benchmark.metrics.spans import stage_ms_per_map


def read(run):
    return stage_ms_per_map(run, "forward.pairs")
