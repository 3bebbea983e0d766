"""The soft-argmin kernel's share of its roofline: over the traced window, the sum of each
launch's least time (benchmark.roofline.softargmin_bound_s, float32 cost volumes, no
statistics: inference) over the kernel's device time. The launches by shape are the
program's own counter (ops.softargmin.softargmin_cuda.shape_launches)."""

from benchmark import roofline
from benchmark.metrics.common import matcher, traced


def read(run):
    shapes = run.counters.get("softargmin_shapes")
    if not traced(run) or not shapes:
        return None
    import torch

    kind = roofline.part(torch.cuda.get_device_name(run.device))
    seconds = run.trace.kernel_s(matcher(("softargmin_kernel",)))
    if seconds <= 0:
        return None
    bound = sum(n * roofline.softargmin_bound_s(shape, 4, kind)[0]
                for shape, n in shapes.items())
    return 100.0 * bound / seconds
