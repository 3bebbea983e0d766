"""The port's mesh layer (atvsnet_torch.parallel.mesh) and AAM's view collectives, on the
CPU.

  * parse_mesh_spec and auto_mesh_shape are the JAX package's copies: equal results and
    the same errors over a grid that holds tests/test_parallel.py's cases;
  * on a gloo world of 2 processes: make_mesh refuses a world of the wrong size (with the
    'depth' axis too: tests/test_torch_parallel_depth.py holds that axis), and lays out
    rows and pairs as P('data') and P('view') do; AAM over a
    (1, 2) mesh's view group against AAM on all four views in one process, forward and
    backward (bound 1e-5 of each tensor's scale: the sums are cut in two and added in
    another order; measured ~1e-7); the weight gradients summed over the ranks and divided
    by n_view, as models.train does, against the one-process gradients;
  * without a group, attention_aggregate_stacked is to the bit the formula it had before
    the group argument came in.
"""

import numpy as np
import pytest
import torch

from atvsnet_tpu.parallel import mesh as jmesh
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.nn import layers as L
from atvsnet_torch.nn.aam import attention_aggregate_stacked
from atvsnet_torch.params import init_model
from atvsnet_torch.parallel import mesh as tmesh

from tests._torch_world import mesh_cases, run_world

SPECS = ["data=2,view=4", "view=2", "data=3", "", "data=1,view=1,", " view=8", "data=2,view=x",
         "depth=2", "data=2,pairs=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jmesh.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert tmesh.parse_mesh_spec(spec) == want


def test_auto_mesh_shape_matches_jax():
    assert tmesh.auto_mesh_shape(8, 4) == (2, 4)        # tests/test_parallel.py's cases
    assert tmesh.auto_mesh_shape(4, 4) == (1, 4)
    assert tmesh.auto_mesh_shape(2, 4) == (1, 2)
    assert tmesh.auto_mesh_shape(1, 4) == (1, 1)
    assert tmesh.auto_mesh_shape(8, 7) == (8, 1)
    for n in range(1, 17):
        for pairs in range(1, 12):
            assert tmesh.auto_mesh_shape(n, pairs) == jmesh.auto_mesh_shape(n, pairs), (n, pairs)


def test_block_refuses_uneven_splits():
    assert tmesh.block(8, 4, 3) == slice(6, 8)
    with pytest.raises(ValueError, match="equal blocks"):
        tmesh.block(5, 2, 0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("mesh"), 2, mesh_cases)


def test_make_mesh_checks_and_layout(world):
    for rank, res in enumerate(world):
        assert "needs 4 processes, the world has 2" in res["errors"]["world_size"]
        # the 'depth' axis is a third mesh axis now: on a world of 2, (1, 2, 2) is too big
        assert res["errors"]["depth_axis"] == ("ValueError: a (1, 2, 2) mesh needs 4 processes, "
                                               "the world has 2")
        lay = res["layout"]
        assert (lay["n_data"], lay["n_view"], lay["data_rank"], lay["view_rank"]) == (1, 2, 0, rank)
        assert lay["pairs"] == [2 * rank, 2 * rank + 1]
        assert lay["rows"] == list(range(6))
        assert lay["groups"] == (True, False)       # no group on an axis of extent 1
        lay = res["layout_data"]
        assert lay["data_rank"] == rank and lay["pairs"] == [0, 1, 2, 3]
        assert lay["rows"] == list(range(3 * rank, 3 * rank + 3))


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_aam_over_the_view_group_matches_one_process(world):
    single = world[0]["single"]
    for res in world:
        _close(res["sharded"]["out"], single["out"])
    # both ranks differentiate the same (replicated) loss, so the world differentiates it
    # twice: every gradient, of each rank's views and of the weights, is divided by n_view
    x_grad = np.concatenate([res["sharded"]["x_grad"] for res in world]) / 2
    _close(x_grad, single["x_grad"])
    for w in ("w_unique", "w_shared"):
        summed = sum(res["sharded"][w] for res in world) / 2
        _close(summed, single[w])
        # each rank alone holds only part of it: the collectives' backward is needed
        assert np.abs(world[0]["sharded"][w] - single[w]).max() > 1e-3 * np.abs(single[w]).max()


def test_gather_blocks_order_and_gradient(world):
    for res in world:
        np.testing.assert_array_equal(res["gather"]["value"], [[1.0] * 3, [2.0] * 3])
    # each block's gradient is the sum over both ranks' uses of it
    np.testing.assert_array_equal(world[0]["gather"]["grad"], [[2.0, 4.0, 6.0]])
    np.testing.assert_array_equal(world[1]["gather"]["grad"], [[8.0, 10.0, 12.0]])


def test_aam_without_group_is_the_formula_it_had():
    cfg = PipelineConfig(view_num=5, max_d=8, max_h=32, max_w=32)
    att = init_model(cfg, seed=2, device="cpu").aam2_att
    x = torch.randn((4, 2, 8, 8, 8, cfg.crm_base_filter), generator=torch.Generator().manual_seed(3))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        N, B, C = xd.shape[0], xd.shape[1], xd.shape[-1]
        w_cat = torch.cat([att.weight_unique, att.weight_shared], dim=0)
        both = L.conv(xd.reshape((N * B,) + xd.shape[2:]), w_cat, relu=True).reshape(
            xd.shape[:-1] + (2 * C,))
        unique, shared = both[..., :C], both[..., C:]
        act = (unique - shared + shared.sum(dim=0, keepdim=True)).to(torch.float32)
        want = torch.sum(torch.softmax(act, dim=0).to(dtype) * xd, dim=0)
        assert torch.equal(attention_aggregate_stacked(att, xd), want)
