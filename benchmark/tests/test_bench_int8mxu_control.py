"""On the card, the int8mxu cell at its own size with a short window, on three seeds: the
program's run comes out correct, and each of three controls does not.

  (a) tf32_reference: the int8mxu reference with TF32 allowed in its float convs, in the
      forward's place (the precision below the float32 that the configuration states);
  (b) int8s: the program with its links quantized but its convs float (the operand
      quantization left out);
  (c) none: the program without quantization.

Each run prints its compared numbers as one JSON line. Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider -s \
        benchmark/tests/test_bench_int8mxu_control.py
"""

import json
import os
import time

import pytest
import torch

from benchmark import harness

CELL = "serve5.int8mxu"
SEEDS = [2 ** 31 + 103, 2 ** 32 + 7, 3_000_000_019]


def _tf32_reference(weights_path, device, act_range):
    """The int8mxu reference, TF32 allowed, with the program's forward's signature."""
    from benchmark.reference import int8mxu
    from benchmark.reference.weights import load_weights

    p = load_weights(weights_path, device)

    def forward(model, images, cams, cfg, out_prob_map=False, upsample=True):
        return int8mxu.forward(p, images, torch.as_tensor(cams, device=images.device),
                               cfg.max_d, act_range, upsample=upsample, tf32=True)

    return forward


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["program", "tf32_reference", "int8s", "none"])
def test_the_controls_fail_where_the_program_passes(monkeypatch, variant, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import atvsnet_torch.serving as serving

    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, CELL)
    if variant in ("int8s", "none"):
        config = dict(config, act_quant=variant)
    if variant == "tf32_reference":
        monkeypatch.setattr(serving, "multi_view_forward", _tf32_reference(
            os.path.join(harness.ROOT, config["weights"]), torch.device("cuda"),
            config["act_quant_range"]))
    out = harness.run_cell(spec, cell, config, traffic, seed=seed, seconds=5.0, trace=False,
                           t_start=time.perf_counter(), device="cuda")
    print(json.dumps({"variant": variant, "seed": seed, "attempted": out["attempted"],
                      "compared": out["compared"], "readings": out["readings"]}), flush=True)
    assert out["attempted"] > 0
    assert out["correct"] is (variant == "program"), out["compared"]
