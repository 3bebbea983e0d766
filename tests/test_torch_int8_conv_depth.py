"""act_quant="int8mxu" on a depth split: a gloo world of 2 processes on the CPU, depth=2,
against one process. This file imports torch and the port only (its rank function runs
in the world's processes); tests/test_torch_int8_conv.py holds the port against JAX.

  * The int8 conv (qin=True) of a block of planes, stride 1 and 2: the block's halo comes
    first and the quantization is elementwise, so the gathered blocks equal the one-process
    conv to the bit (the sums are exact integers either way).
  * The sharded forward on a (1, 1, 2) mesh (3 views, 32x32, D=16, the trained spheres
    weights on a rendered scene) against the same forward in one process. The split's batch
    norm sums its statistics in another order, and a link within that rounding of a
    lattice tie lands one step away, which the later links amplify: the bounds are those of
    the quantized forward against JAX (tests/test_torch_quant.py), mean 2e-3 and max 1e-2
    sweep units. Measured (torch 2.13 CPU): mean 5.8e-8, max 2.4e-7 on every key, float
    noise of the merged soft-argmin; no link flipped at this size.
"""

import os

import numpy as np
import pytest
import torch

from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import render_multiplane_scene
from atvsnet_torch.nn import layers as L
from atvsnet_torch.params import load_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd

from tests._torch_world import numpy_tree, run_world

SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                       "trained_demo", "spheres_params.npz")
SIZE = dict(view_num=3, max_d=16, max_h=32, max_w=32, act_quant="int8mxu")
KEYS = ("depth_agg_initial", "depth_views", "depth")
MEAN_BOUND, MAX_BOUND = 2e-3, 1e-2
CONVS = {"s1 8->8": (1, 8, 8), "s2 8->16": (2, 8, 16), "s1 16->1": (1, 16, 1)}


def _scene():
    s = render_multiplane_scene(view_num=3, H=32, W=32, D=16, seed=3, num_spheres=2)
    return s["images"], s["cams"]


def _convs(depth_num=16):
    """{name: (stride, volume (2, depth_num, 6, 5, Ci), kernel (Co, Ci, 3, 3, 3))}."""
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, (stride, ci, co) in CONVS.items():
        x = torch.randint(0, 256, (2, depth_num, 6, 5, ci), generator=g) * (6.0 / 255.0)
        out[name] = (stride, x.to(torch.float32), torch.randn((co, ci, 3, 3, 3), generator=g) * 0.2)
    return out


def _rank_cases(images, cams):
    """On each rank: the split int8 convs, gathered, and the sharded forward."""
    from atvsnet_torch.parallel.depth import DepthSplit
    from atvsnet_torch.parallel.mesh import gather_blocks, make_mesh
    from atvsnet_torch.parallel.pipeline import sharded_forward

    mesh = make_mesh(1, 1, 2, device="cpu")
    res = {}
    for name, (stride, x, w) in _convs().items():
        split = DepthSplit.of(mesh, x.shape[1])
        y = L.conv(x[:, split.planes], w, stride=stride, split=split, quant=L.ActQuant("int8mxu"),
                   qin=True)
        res[name] = gather_blocks(y, split.group, dim=1)
    cfg = PipelineConfig(**SIZE)
    res["forward"] = sharded_forward(mesh, cfg)(load_model(SPHERES, cfg, device="cpu"), images,
                                                cams)
    return numpy_tree(res)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    images, cams = _scene()
    world = run_world(tmp_path_factory.mktemp("int8_depth"), 2, _rank_cases, images, cams)
    cfg = PipelineConfig(**SIZE)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        single = multi_view_forward_spmd(load_model(SPHERES, cfg, device="cpu"), images, cams, cfg)
    return world, {k: v.numpy() for k, v in single.items()}


@pytest.mark.parametrize("name", list(CONVS))
def test_split_int8_conv_equals_one_process_to_the_bit(results, name):
    world, _ = results
    stride, x, w = _convs()[name]
    want = L.conv(x, w, stride=stride, quant=L.ActQuant("int8mxu"), qin=True).numpy()
    for rank in world:
        np.testing.assert_array_equal(rank[name], want)
    assert np.abs(want - L.conv(x, w, stride=stride).numpy()).max() > 0


@pytest.mark.parametrize("key", KEYS)
def test_depth2_int8mxu_forward_matches_one_process(results, key):
    world, single = results
    for rank in world:
        got = rank["forward"][key]
        assert got.shape == single[key].shape and np.isfinite(got).all()
        diff = np.abs(got - single[key])
        assert diff.mean() <= MEAN_BOUND and diff.max() <= MAX_BOUND, (diff.mean(), diff.max())
        np.testing.assert_array_equal(got, world[0]["forward"][key])
