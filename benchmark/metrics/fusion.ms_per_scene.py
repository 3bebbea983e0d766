"""Milliseconds per fuse_scene call over the window: the harness's span around each call
(confidence filter, consistency check, PLY), averaged."""


def read(run):
    n = run.spans.count("scene.fuse_scene")
    return 1e3 * run.spans.total_s("scene.fuse_scene") / n if n else None
