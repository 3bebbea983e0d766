"""On the card, at each cell's own size with a short window: the program's run comes out
correct, and the control's (the reference in TF32 in the forward's place, the precision
below the float32 that the configurations state) does not. Skips without a card.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_control.py
"""

import time

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eval8.eth3d_scenes", "serve5.full_frames",
                                  "serve5.small_frames"])
@pytest.mark.parametrize("control", [False, True])
def test_the_control_fails_where_the_program_passes(monkeypatch, name, control):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import atvsnet_torch.serving as serving

    # run_cell puts the control in the forward's place; the test gives it back
    monkeypatch.setattr(serving, "multi_view_forward", serving.multi_view_forward)
    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, name)
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 101, seconds=5.0,
                           trace=False, t_start=time.perf_counter(), device="cuda",
                           control=control)
    assert out["attempted"] > 0
    assert out["correct"] is (not control), out["compared"]
