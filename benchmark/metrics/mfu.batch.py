"""The whole forward's share of the card's float32 peak over the traced window: the
analytic FLOPs of a map (benchmark.flops) times the maps completed, over the window's
seconds, over 67 TFLOP/s."""

from benchmark.metrics.common import mfu


def read(run):
    return mfu(run)
