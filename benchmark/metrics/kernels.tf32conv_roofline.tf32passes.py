"""The pass leaves' convs and matmuls as a share of their roofline (fp32_precision
"default", on the TF32 tensor cores): over the traced window, the sum of each counted leaf
call's least time (benchmark.roofline_tf32.leaf_bound_s) over the device time of the
trace's conv and matrix-product kernels, the names nn.conv_ms_per_map.* counts (cuDNN's and
cuBLAS's, their layout and fill kernels among them). In this cell every conv is a pass
leaf; the served forward's interpolation matmuls, which no leaf runs, are in the device
time too and lower the share by their few ms a map. The calls by shape are the program's
own counts (ops.fp32_passes `pass_conv`, `pass_conv_transpose`, `pass_matmul`
`.shape_launches`), which the driver reads over the traced window."""

from benchmark import roofline
from benchmark.metrics.common import matcher, traced
from benchmark.roofline_tf32 import leaf_bound_s

KERNELS = ("conv", "gemm", "fft", "xmma", "cutlass", "winograd", "cudnn", "sm90_", "sm80_")
EXCLUDE = ("softargmin",)


def read(run):
    shapes = run.counters.get("pass_shapes")
    if not traced(run) or not shapes:
        return None
    import torch

    kind = roofline.part(torch.cuda.get_device_name(run.device))
    seconds = run.trace.kernel_s(matcher(KERNELS, EXCLUDE))
    if seconds <= 0:
        return None
    return 100.0 * sum(n * leaf_bound_s(key, kind)[0] for key, n in shapes.items()) / seconds
