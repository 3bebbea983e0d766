"""Device ms per map in the gathers of the plane-sweep sampling and the confidence
(index_select and gather kernels)."""

from benchmark.metrics.common import device_ms_per_map

PATTERNS = ("indexselect", "index_select", "gather")


def read(run):
    return device_ms_per_map(run, PATTERNS)
