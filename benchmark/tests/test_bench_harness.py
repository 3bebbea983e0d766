"""A whole run of each cell's driver on the CPU at a tiny size, past the harness's look for
a card: a sound run comes out correct, and one with an answer altered where the forward
produces it comes out not correct. (The cells here have no other fault to plant: batch 1,
one process, no training state.)"""

import copy
import time

import pytest
import torch

from benchmark import harness

TINY = {"view_num": 3, "max_h": 64, "max_w": 96, "max_d": 16}


def _cell(name):
    spec = harness.load_spec()
    cell, config, traffic = harness.cell_files(spec, name)
    config = dict(config, **TINY)
    traffic = copy.deepcopy(traffic)
    if traffic["driver"] == "eval_scenes":
        traffic.update(frame=[70, 100], images_per_scene=4, scenes=1)
    else:
        config["buckets"] = [[32, 64]]
        traffic.update(frame_h=[50, 64], frame_w=[80, 96], rigs=1, views_per_rig=4, pool=3)
    return spec, cell, config, traffic


def _altered(monkeypatch, call):
    """The served forward, with the depth of every call from number `call` on moved by 5%
    (a fault in the forward moves every answer after the warm-up)."""
    import atvsnet_torch.serving as serving

    forward, calls = serving.multi_view_forward, []

    def altered(*args, **kw):
        out = forward(*args, **kw)
        calls.append(1)
        if len(calls) >= call:
            out = dict(out, depth=out["depth"] * 1.05)
        return out

    monkeypatch.setattr(serving, "multi_view_forward", altered)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["eval8.eth3d_scenes", "serve5.full_frames",
                                  "serve5.small_frames"])
@pytest.mark.parametrize("fault", [False, True])
def test_a_run_on_the_cpu(monkeypatch, name, fault):
    spec, cell, config, traffic = _cell(name)
    if fault:
        # the warm-up's calls come first: 1 in the eval driver, 2 in the serving one
        _altered(monkeypatch, 2 if traffic["driver"] == "eval_scenes" else 3)
    out = harness.run_cell(spec, cell, config, traffic, seed=2 ** 31 + 7, seconds=0.5,
                           trace=False, t_start=time.perf_counter(), device="cpu")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is (not fault), out["compared"]
    assert list(out)[-1] == "compared"
    for m in spec["end_to_end"]:
        assert (m["name"] in out["metrics"]) == harness.applies(m, name)
