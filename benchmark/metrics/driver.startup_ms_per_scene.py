"""Host ms from run_eval_pc's entry until its first forward is queued (the span
eval.startup: the model's build and weights, the pools, the first batch's load), averaged
over the calls in the traced window, one scene each."""

from benchmark.metrics.spans import host_ms


def read(run):
    return host_ms(run, "eval.startup")
