"""One run of one cell: find its configuration, traffic and metrics by name, set up the
program, measure a window, check the answers against the reference, and make the result
line.

A driver (benchmark/drivers/<name>.py, named by the traffic file's "driver") knows how to
feed one kind of traffic to the program:

    setup(run) -> state       build the program's objects, render inputs, warm up
    window(run, state)        the measured window: fills run.values, run.attempted,
                              run.failed, run.maps_traced, run.counters; traces its own part
    release(run, state)       drop the program's device state
    check(run, state)         the reference's comparison: fills run.checks
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import tempfile
import time

from benchmark import flops
from benchmark.trace import DeviceTrace, Spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str):
    """(cell, configuration, traffic) of a workload named in the spec."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The per-layer metric's reader, benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What a driver, the checks and the metric readers share about one run."""

    def __init__(self, cell: str, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device, workdir: str, control: bool = False):
        import torch

        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.device = seed, seconds, torch.device(device)
        self.workdir, self.control = workdir, control
        self.spans = Spans()
        self.trace = DeviceTrace() if trace else None
        self.values = {}          # end-to-end readings of the window by metric name
        self.counters = {}        # the program's own counters and clocks, for the readers
        self.checks = {}          # name -> (reading, limit)
        self.attempted = self.failed = 0
        self.maps_traced = 0
        self.flops_traced = 0     # the model FLOPs of the maps completed in the traced part
        self.readings = {}        # numbers printed beside the result, not compared
        self.window_s = None
        self.weights = os.path.join(ROOT, config["weights"])
        self.flops_per_map = self.flops_of(config["max_h"], config["max_w"])

    @property
    def program_device(self):
        """The `device` argument for the program's entry points: None (their CUDA default)
        on the card, the device's name otherwise."""
        return None if self.device.type == "cuda" else str(self.device)

    def flops_of(self, h: int, w: int) -> int:
        """Model FLOPs of one map at an (h, w) bucket of this configuration."""
        c = self.config
        return flops.forward_flops(c["view_num"], h, w, c["max_d"], upsample=c["upsample"],
                                   fem_f=c["fem_base_filter"], shallow_f=c["shallow_base_filter"],
                                   crm_f=c["crm_base_filter"],
                                   refine_f=c["refine_base_filter"])["total"]

    def rng(self, *stream):
        """A numpy generator for one named stream of this run's seed."""
        import zlib

        import numpy as np

        words = [int(self.seed) % (2 ** 64)] + [zlib.crc32(s.encode()) for s in stream]
        return np.random.default_rng(np.random.SeedSequence(words))

    def pipeline_config(self):
        from atvsnet_torch.config import PipelineConfig

        keys = ("view_num", "max_d", "max_h", "max_w", "sample_scale", "inverse_depth",
                "compute_dtype", "bn_eps", "pair_batch", "reference_compat", "act_quant",
                "warp_quant", "fp32_precision", "fem_base_filter", "crm_base_filter",
                "shallow_base_filter", "refine_base_filter")
        return PipelineConfig(**{k: self.config[k] for k in keys})


def _control_forward(weights_path: str, device):
    """The reference in the program's forward's place, computed in TF32: the lower
    precision below the float32 that the configurations state."""
    import torch

    from benchmark.reference import model as ref_model
    from benchmark.reference.weights import load_weights

    p = load_weights(weights_path, device)

    def forward(model, images, cams, cfg, out_prob_map=False, upsample=True):
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return ref_model.forward(p, images, torch.as_tensor(cams, device=images.device),
                                     cfg.max_d, upsample=upsample)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    return forward


def check_weights(config: dict) -> None:
    from benchmark.reference.weights import sha256

    got = sha256(os.path.join(ROOT, config["weights"]))
    if got != config["weights_sha256"]:
        raise SystemExit(f"{config['weights']} has changed (sha256 {got}); the configuration "
                         f"was measured with {config['weights_sha256']}: add a configuration")


def run_cell(spec: dict, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, t_start: float, device="cuda", control: bool = False) -> dict:
    """One run; returns the result line's object."""
    import torch

    check_weights(config)
    driver = importlib.import_module("benchmark.drivers." + traffic["driver"])
    workdir = tempfile.mkdtemp(prefix="atvsnet-bench-")
    try:
        run = Run(cell["name"], config, traffic, seed, seconds, trace, device, workdir, control)
        if control:
            import atvsnet_torch.serving

            atvsnet_torch.serving.multi_view_forward = _control_forward(run.weights, run.device)
        on_gpu = run.device.type == "cuda"
        state = driver.setup(run)
        setup_s = time.perf_counter() - t_start
        driver.window(run, state)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        driver.release(run, state)
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
        driver.check(run, state)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    if not trace:
        run.values["setup_s"] = setup_s
        run.values["peak_mem_gb"] = peak / 1e9
        for m in spec["end_to_end"]:
            if applies(m, run.cell):
                metrics[m["name"]] = {"value": run.values[m["name"]], "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if applies(m, run.cell):
                value = reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (run.attempted > 0 and run.failed == 0 and bool(run.checks)
               and all(v <= lim for v, lim in run.checks.values()))
    device_info = {"platform": "gpu" if on_gpu else run.device.type,
                   "kind": torch.cuda.get_device_name(run.device) if on_gpu else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if trace and run.trace.t1 is not None:
        run.readings.update(maps_traced=run.maps_traced, flops_traced=run.flops_traced,
                            device_operations=len(run.trace.events))
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown(run.spans)
    out["readings"] = run.readings
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out
