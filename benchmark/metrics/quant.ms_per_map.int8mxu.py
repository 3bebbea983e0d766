"""Device ms per map in the quantization of act_quant="int8mxu": the time between the CUDA
events of every `quant.act` span (a volume link's int8 round trip, nn.layers.quantize_act)
and every `quant.operands` span (a qin conv's int8 operands, nn.layers.quant_conv_operands)
in the traced window, summed, over the maps traced. None where the window holds no such
spans (a program without them) or where one lacks its device time."""

from benchmark.metrics.spans import stage_ms_per_map


def read(run):
    act = stage_ms_per_map(run, "quant.act")
    operands = stage_ms_per_map(run, "quant.operands")
    if act is None or operands is None:
        return None
    return act + operands
