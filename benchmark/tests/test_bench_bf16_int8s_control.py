"""On the card, the cell serve5.bf16_int8s at its own size with a short window, on three
seeds: the program's run comes out correct, and controls (a) and (c) do not.

  (a) bits6: the mode's reference with its roundings at 6 significant bits in place of
      bf16's 8, in the forward's place: a precision below the configuration's;
  (b) no_lattices: the program in bf16 with act_quant="none" and warp_quant="none" (the
      two int8 round trips left out);
  (c) tf32_reference: the frozen fp32 reference with TF32 allowed in the forward's place
      (run.py --control): plain TF32, which is neither mode.

Each run prints its compared numbers as one JSON line; PERF.md section 2 gives them beside
the limits. (b) is a reading: the lattices move the maps by less than bf16's own chaos does,
so no limit with room on both sides tells it apart (tests/test_torch_bf16_int8s_reference.py
proves the round trips on the CPU). Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider -s \
        benchmark/tests/test_bench_bf16_int8s_control.py
"""

import json
import os
import time

import pytest
import torch

from benchmark import harness

CELL = "serve5.bf16_int8s"
SEEDS = [2 ** 31 + 251, 2 ** 32 + 37, 3_000_000_259]
CORRECT = {"program": True, "bits6": False, "tf32_reference": False}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["program", "bits6", "no_lattices", "tf32_reference"])
def test_the_controls_fail_where_the_program_passes(monkeypatch, variant, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import atvsnet_torch.serving as serving
    from benchmark.drivers import serve_bf16_int8s

    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, CELL)
    weights = os.path.join(harness.ROOT, config["weights"])
    if variant == "no_lattices":
        config = dict(config, act_quant="none", warp_quant="none")
    if variant == "bits6":          # undone after the test
        monkeypatch.setattr(serving, "multi_view_forward", serve_bf16_int8s.reference_forward(
            weights, torch.device("cuda"), 6))
    if variant == "tf32_reference":     # run.py --control's forward, undone after the test
        monkeypatch.setattr(serving, "multi_view_forward", harness._control_forward(
            weights, torch.device("cuda")))
    out = harness.run_cell(spec, cell, config, traffic, seed=seed, seconds=5.0, trace=False,
                           t_start=time.perf_counter(), device="cuda")
    print(json.dumps({"variant": variant, "seed": seed, "attempted": out["attempted"],
                      "correct": out["correct"], "compared": out["compared"],
                      "readings": out["readings"]}), flush=True)
    assert out["attempted"] > 0
    if variant in CORRECT:
        assert out["correct"] is CORRECT[variant], out["compared"]
