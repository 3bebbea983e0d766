"""What the per-layer readers share: reading the traced window of a run (run.trace, a
benchmark.trace.DeviceTrace), per map and as shares. Each reader returns None where its
run has nothing to read."""

from __future__ import annotations

from benchmark import roofline


def traced(run) -> bool:
    return run.trace is not None and run.trace.t1 is not None and run.maps_traced > 0


def matcher(patterns, exclude=()):
    pats = tuple(p.lower() for p in patterns)
    excl = tuple(p.lower() for p in exclude)

    def match(name: str) -> bool:
        n = name.lower()
        return any(p in n for p in pats) and not any(p in n for p in excl)

    return match


def device_ms_per_map(run, patterns, exclude=()):
    """Device milliseconds per map of the traced operations whose names hold one of the
    patterns (and none of `exclude`), or None if there are none."""
    if not traced(run):
        return None
    seconds = run.trace.kernel_s(matcher(patterns, exclude))
    return seconds * 1e3 / run.maps_traced if seconds > 0 else None


def mfu(run):
    """The model's FLOPs of the maps completed in the traced window (each at the bucket it
    ran in) over the window's seconds, as a share of the card's float32 peak (%)."""
    if not traced(run) or run.device.type != "cuda":
        return None
    import torch

    peak = roofline.PEAKS[roofline.part(torch.cuda.get_device_name(run.device))]
    return 100.0 * run.flops_traced / run.trace.window_s / peak["fp32_flop_per_s"]


def idle_share(run):
    """The share of the traced window in which no operation ran on the device (%)."""
    if not traced(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
