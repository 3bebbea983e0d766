"""The int8 conv kernel's share of its roofline (act_quant="int8mxu"): over the traced
window, the sum of each launch's least time (benchmark.roofline_int8.int8_bound_s, fp32
output as the served forward writes it) over the device time of the trace's conv3d_int8
kernels (the ring, ring_cluster and generic paths alike). The launches by shape are the
program's own counter (ops.int8_conv.conv3d_int8_cuda.shape_launches), which the driver
reads over the traced window."""

from benchmark import roofline
from benchmark.metrics.common import matcher, traced
from benchmark.roofline_int8 import int8_bound_s


def read(run):
    shapes = run.counters.get("int8_conv_shapes")
    if not traced(run) or not shapes:
        return None
    import torch

    kind = roofline.part(torch.cuda.get_device_name(run.device))
    seconds = run.trace.kernel_s(matcher(("conv3d_int8",)))
    if seconds <= 0:
        return None
    return 100.0 * sum(n * int8_bound_s(key, 4, kind)[0] for key, n in shapes.items()) / seconds
