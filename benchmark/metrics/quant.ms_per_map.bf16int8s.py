"""Device ms per map in the two int8 lattices of the bf16 speed mode: the time between the
CUDA events of every `quant.act` span (a volume link's int8s round trip,
nn.layers.quantize_act) and every `quant.warp` span (a plane-sweep volume's int8 round
trip, geometry.warp.quantize_warp) in the traced window, summed, over the maps traced.
None where the window holds no spans of either name (a program without them) or where one
lacks its device time."""

from benchmark.metrics.spans import stage_ms_per_map


def read(run):
    act = stage_ms_per_map(run, "quant.act")
    warp = stage_ms_per_map(run, "quant.warp")
    if act is None or warp is None:
        return None
    return act + warp
