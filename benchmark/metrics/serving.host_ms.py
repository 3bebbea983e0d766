"""Median host milliseconds per request outside the program's own runtime_s: the wall time
around DepthEstimator.predict less its runtime_s (upload, forward and download), so the
preparation of the frames, the routing and the unpacking."""

import statistics


def read(run):
    host = run.counters.get("host_s")
    return 1e3 * statistics.median(host) if host else None
