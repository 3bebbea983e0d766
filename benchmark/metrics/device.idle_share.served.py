"""Share of the traced window with no operation on the device: one minus the union of the
trace's operation intervals over the window's length."""

from benchmark.metrics.common import idle_share


def read(run):
    return idle_share(run)
