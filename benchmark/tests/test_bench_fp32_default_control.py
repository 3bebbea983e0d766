"""On the card, the cell serve5.full_tf32passes at its own size with a short window, on three
seeds: the program's run comes out correct, and controls (a) and (c) do not.

  (a) bfloat16: the program at compute_dtype="bfloat16", a precision below the float32
      results that the configuration states;
  (b) highest: the program at fp32_precision="highest" (the rounding left out);
  (c) tf32_reference: the frozen fp32 reference with TF32 allowed in the forward's place
      (run.py --control): plain TF32, which is neither mode.

Each run prints its compared numbers as one JSON line; PERF.md section 2 gives them beside
the limits. (b) is a reading: the depth limit tells it apart on these seeds, but by too
little to hold it to that. Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider -s \
        benchmark/tests/test_bench_fp32_default_control.py
"""

import json
import os
import time

import pytest
import torch

from benchmark import harness

CELL = "serve5.full_tf32passes"
SEEDS = [2 ** 31 + 211, 2 ** 32 + 29, 3_000_000_223]
CORRECT = {"program": True, "bfloat16": False, "tf32_reference": False}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["program", "bfloat16", "highest", "tf32_reference"])
def test_the_controls_fail_where_the_program_passes(monkeypatch, variant, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import atvsnet_torch.serving as serving

    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, CELL)
    if variant == "bfloat16":
        config = dict(config, compute_dtype="bfloat16")
    if variant == "highest":
        config = dict(config, fp32_precision="highest")
    if variant == "tf32_reference":     # run.py --control's forward, undone after the test
        monkeypatch.setattr(serving, "multi_view_forward", harness._control_forward(
            os.path.join(harness.ROOT, config["weights"]), torch.device("cuda")))
    out = harness.run_cell(spec, cell, config, traffic, seed=seed, seconds=5.0, trace=False,
                           t_start=time.perf_counter(), device="cuda")
    print(json.dumps({"variant": variant, "seed": seed, "attempted": out["attempted"],
                      "correct": out["correct"], "compared": out["compared"],
                      "readings": out["readings"]}), flush=True)
    assert out["attempted"] > 0
    if variant in CORRECT:
        assert out["correct"] is CORRECT[variant], out["compared"]
