"""The bf16 conv leaves as a share of their roofline (compute_dtype "bfloat16", on the bf16
tensor cores): over the traced window, the sum of each counted leaf call's least time
(benchmark.roofline_bf16.leaf_bound_s) over the device time of the trace's conv and
matrix-product kernels, the names nn.conv_ms_per_map.* counts (cuDNN's and cuBLAS's, their
layout and fill kernels among them). In this cell every conv is a bf16 leaf; the served
forward's interpolation matmuls, which no leaf runs, are in the device time too and lower
the share by their few ms a map. The calls by shape are the program's own counts
(nn.layers.bf16_conv.shape_launches), which the driver reads over the traced window."""

from benchmark import roofline
from benchmark.metrics.common import matcher, traced
from benchmark.roofline_bf16 import leaf_bound_s

KERNELS = ("conv", "gemm", "fft", "xmma", "cutlass", "winograd", "cudnn", "sm90_", "sm80_")
EXCLUDE = ("softargmin",)


def read(run):
    shapes = run.counters.get("bf16_conv_shapes")
    if not traced(run) or not shapes:
        return None
    import torch

    kind = roofline.part(torch.cuda.get_device_name(run.device))
    seconds = run.trace.kernel_s(matcher(KERNELS, EXCLUDE))
    if seconds <= 0:
        return None
    return 100.0 * sum(n * leaf_bound_s(key, kind)[0] for key, n in shapes.items()) / seconds
