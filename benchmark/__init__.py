"""The benchmark of atvsnet_torch, the PyTorch and CUDA port, on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the root of the repo names the cells, the end-to-end and the per-layer
metrics. Everything else is found by name from its entries:

    benchmark/configs/<config>.json     a configuration: sizes, numerics, weights, entry
    benchmark/traffic/<traffic>.json    a traffic mix: the parameters of one of the drivers
    benchmark/metrics/<metric>.py       a per-layer metric: read(ctx) -> number or None
    benchmark/drivers/<driver>.py       the code that drives a traffic kind through the
                                        program and checks its answers (run(ctx))

The yardstick lives here too: the scene generator (scenes), the reference forward,
preparation and fusion (reference/), the FLOP count (flops), the peaks and the
soft-argmin's bound (roofline), the statistics and the union of kernel intervals (stats),
the profiler window (trace), the comparisons that decide `correct` (check), and the import
guard (guard).
"""
