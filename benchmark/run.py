"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU. It loads the cell's
configuration and traffic by name from BENCHMARK.json, sets the program up, warms the
cell's shapes, measures for --seconds, checks the answers against the plain reference
(benchmark/reference/), and prints one JSON line last on standard output; the numbers
compared, each beside its limit, are also the last lines on standard error. --trace 1
reports the per-layer metrics from a device trace instead of the end-to-end ones.
--control runs the reference in TF32 in the forward's place: a run whose `correct` has
to come out false (the check's control).

Without a CUDA device, or with fewer than the cell asks for, it exits with 2 and prints no
result; it never falls back to the CPU. It exits with 3 if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
# every build and kernel cache at a fixed place inside the checkout (the port's nvcc
# libraries go to build/atvsnet_torch/ on their own)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "bench_cache", "triton")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    from benchmark import guard, harness

    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, cell, config, traffic, args.seed, args.seconds,
                              bool(args.trace), T_START, control=args.control)
    banned = guard.loaded()
    if banned:
        print(f"the run loaded {banned}: the benchmark measures atvsnet_torch alone",
              file=sys.stderr)
        return 3
    print("readings " + json.dumps(result["readings"]), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
