"""The device's idle time while the host is inside the forward issuing its launches: the
gaps between the trace's operations that fall inside the union of the `forward` spans'
host intervals, over the traced window's length (%). The most that taking the host's
launches off the path (CUDA graphs) could save."""

from benchmark.metrics.spans import idle_inside_share


def read(run):
    return idle_inside_share(run, "forward")
