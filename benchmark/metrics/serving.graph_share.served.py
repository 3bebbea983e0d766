"""The share of the served requests' forwards in the traced window that ran as a replay of
their program's CUDA graph (serving.ServingGraph): 100 x the `serve.graph.replay` spans
over the `serve.forward` spans (%). None in a program without the graphs."""

from benchmark.metrics.graphs import graph_share


def read(run):
    return graph_share(run)
