"""What the readers of the served requests' CUDA graphs share (serving.DepthEstimator
replays one graph per program after a key's first request; each replay is the host span
`serve.graph.replay` inside the request's `serve.forward`)."""

from __future__ import annotations

from benchmark.metrics.spans import window_spans


def graph_share(run):
    """100 x the `serve.graph.replay` spans over the `serve.forward` spans in the traced
    window: the share of the served forwards that ran as a graph's replay (%). None where
    the window holds no `serve.forward` span, or where the program serves no graphs (no
    serving.ServingGraph)."""
    spans = window_spans(run) or ()
    forwards = sum(s.name == "serve.forward" for s in spans)
    if not forwards:
        return None
    from atvsnet_torch import serving

    if not hasattr(serving, "ServingGraph"):
        return None
    return 100.0 * sum(s.name == "serve.graph.replay" for s in spans) / forwards
