"""The 'depth' mesh axis of the port (atvsnet_torch.parallel.depth and the D-split paths of
nn/, geometry/ and parallel.pipeline) on a gloo world of 4 processes on the CPU.

  * make_mesh(n_data, n_view, n_depth): the ('data', 'view', 'depth') layout, row-major as
    the JAX package reshapes its devices, each rank's block of planes, the groups, and the
    ValueErrors (a world of the wrong size; a D that does not split into 8-divisible
    blocks);
  * every volume op, D=32, on a (1, 1, 4) mesh (two ranks have a neighbour on each side)
    and on (2, 1, 2) (depth=2 in each data group), against the same op on the whole volume
    in one process: the conv at stride 1 and 2, the transposed conv, conv3d_mixed at
    stride 1 and 2, batch_stat_norm and an int8-quantized conv_bn. Outputs, input
    gradients and the weight gradients summed over a depth group within 1e-5 of each
    tensor's scale (the sums are cut at the seams and added in another order; measured
    ~2e-7);
  * the soft-argmin over a split D (the plain partial forward, merge_partials and the
    stats-fed backward, through SplitSoftArgminFunction) against softargmin_torch and
    autograd of it: a pixel whose planes are all +inf (NaN in both), one whose first block
    is all +inf (that rank's triple is (-inf, 0, 0)), one whose estimate sits on a seam.
    Every rank differentiates its copy of the merged depth, so the gradient is n_depth
    times the one-process one (models.train divides). The 4-bin confidence and the
    upsampled soft-argmin split against whole: atol 1e-6. On both meshes;
  * the sharded forward (5 views, 32x32, D=16, a batch of two scenes, the port's seeded
    weights carried over to JAX by export_jax_params) on (1, 2, 2) and (2, 1, 2), so
    depth=2 with view=2 and with data=2: every rank gets the same outputs to the bit;
    against the port's forward in one process at tests/test_torch_parallel_forward.py's
    bounds (depths rtol 1e-5, atol 2e-5; refined volumes, which come back at the whole D,
    rtol 1e-4, atol 5e-4); against the JAX package's multi_view_forward_spmd unsharded at
    tests/test_parallel.py:117-123's rtol 1e-3, atol 1e-4 on depth and depth_agg_initial;
  * DepthEstimator on a built (1, 2, 2) mesh against the estimator in one process
    (metric depths rtol 1e-5, atol 1e-4, as tests/test_torch_parallel_serving.py).
A world of 2 holds the forward and the train step on a (1, 1, 2) mesh
(tests/test_torch_parallel_depth2.py).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.parallel.pipeline import multi_view_forward_spmd as jax_spmd
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.synthetic import synthetic_scene
from atvsnet_torch.params import export_jax_params, init_model
from atvsnet_torch.parallel.pipeline import multi_view_forward_spmd
from atvsnet_torch.serving import DepthEstimator

from tests._torch_world import (depth_mesh_cases, depth_op_cases, depth_serving_cases,
                                depth_softargmin_cases, forward_cases, run_world, several)
from tests.test_torch_serving import _scene_arrays

OP_SHAPES = [(1, 1, 4), (2, 1, 2)]
OPS = ["conv s1", "conv s2", "deconv", "mixed s1", "mixed s2", "batch_stat_norm", "conv_bn int8"]
SIZE = dict(view_num=5, max_d=16, max_h=32, max_w=32)
SHAPES = [(1, 2, 2), (2, 1, 2)]
KEYS = ("depth_agg_initial", "depth_views", "depth", "depth_up", "refined_prob_volumes")
DEPTH_TOL, VOLUME_TOL, JAX_TOL = (dict(rtol=1e-5, atol=2e-5), dict(rtol=1e-4, atol=5e-4),
                                  dict(rtol=1e-3, atol=1e-4))
SERVING = dict(view_num=3, max_d=16, max_h=32, max_w=32)
SERVING_SHAPE = (1, 2, 2)


def _batch():
    scenes = [synthetic_scene(view_num=5, H=32, W=32, D=16, seed=s) for s in (3, 5)]
    return (np.concatenate([i for i, _ in scenes]), np.concatenate([c for _, c in scenes]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The world's results, JAX's unsharded forward (compiled in a thread while the world
    runs) and the port's forward and estimator in one process."""
    cfg = PipelineConfig(**SIZE)
    model = init_model(cfg, seed=0, device="cpu")
    tree = export_jax_params(model)
    images, cams = _batch()
    request = _scene_arrays(3, 32, 32, 16, seed=4)
    jax_out = {}

    def jax_forward():
        out = jax.jit(lambda p, i, c: jax_spmd(p, i, c, JaxConfig(**SIZE)))(
            _unflatten(tree), jnp.asarray(images), jnp.asarray(cams))
        jax_out.update({k: np.asarray(v) for k, v in out.items()})

    thread = threading.Thread(target=jax_forward)
    thread.start()
    try:
        world = run_world(tmp_path_factory.mktemp("depth"), 4, several,
                          (depth_mesh_cases, ()),
                          *[(depth_op_cases, (shape,)) for shape in OP_SHAPES],
                          *[(depth_softargmin_cases, (shape,)) for shape in OP_SHAPES],
                          (forward_cases, (SHAPES, SIZE, tree, images, cams)),
                          (depth_serving_cases, (SERVING_SHAPE, SERVING, request)))
    finally:
        thread.join()
    # each rank's results: the mesh cases, the op cases and the soft-argmin cases per
    # OP_SHAPES, the forward, the estimator
    world = [{"mesh": r[0], "ops": dict(zip(OP_SHAPES, r[1:3])),
              "softargmin": dict(zip(OP_SHAPES, r[3:5])), "forward": r[5], "serving": r[6]}
             for r in world]
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        single = {k: v.numpy() for k, v in multi_view_forward_spmd(model, images, cams, cfg).items()}
        est = DepthEstimator(PipelineConfig(**SERVING), seed=0, device="cpu")
        served = {k: v for k, v in est.predict(*request).items() if isinstance(v, np.ndarray)}
    return world, jax_out, single, served


def test_make_mesh_with_a_depth_axis(results):
    world = results[0]
    for rank, res in enumerate(r["mesh"] for r in world):
        for shape in SHAPES:
            got = res[shape]
            n_data, n_view, n_depth = shape
            assert got["names"] == ("data", "view", "depth") and got["extents"] == shape
            # row-major: rank = (data * n_view + view) * n_depth + depth
            d, v, z = got["ranks"]
            assert (d * n_view + v) * n_depth + z == rank
            assert got["planes"] == (8 * z, 8 * z + 8)
            assert got["split"] == (8 * z, 8, z == 0, z == n_depth - 1)
            assert got["groups"] == (n_data == 1, n_view == 1, False)
        flat = res["two_axes"]
        assert flat["names"] == ("data", "view") and (flat["n_depth"], flat["depth_rank"]) == (1, 0)
        assert flat["split"] is None
        assert res["errors"]["world_size"] == "a (1, 1, 3) mesh needs 3 processes, the world has 4"
        assert "max_d % (8 * n_depth) == 0" in res["errors"]["uneven_planes"]


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", OP_SHAPES)
def test_volume_op_on_a_split_matches_one_process(results, shape, op):
    world = results[0]
    n_depth = shape[2]
    cases = [res["ops"][shape][op] for res in world]
    single = cases[0]["single"]
    for case in cases:
        np.testing.assert_array_equal(case["split"]["out"], cases[0]["split"]["out"])
    if op == "conv_bn int8":
        # a lattice step is 1/127 of the link's max: the statistics' summation order moves
        # a value across a rounding boundary at most rarely, and then by one step
        step = np.abs(single["out"]).max() / 127
        off = np.abs(cases[0]["split"]["out"] - single["out"])
        assert off.max() <= step * 1.01 and np.mean(off > 0) <= 1e-3
        return
    _close(cases[0]["split"]["out"], single["out"])
    # each rank's loss is its planes' share of the whole: the gradients add up
    _close(cases[0]["split"]["x_grad"], single["x_grad"])
    if op != "batch_stat_norm":
        # ranks 0 .. n_depth - 1 are the depth group of data rank 0
        _close(sum(case["split"]["w_grad"] for case in cases[:n_depth]), single["w_grad"])
        # each rank alone holds only its part of the weight's gradient
        assert np.abs(cases[0]["split"]["w_grad"] - single["w_grad"]).max() > 1e-3 * np.abs(
            single["w_grad"]).max()


@pytest.mark.parametrize("shape", OP_SHAPES)
def test_split_softargmin_and_its_gradient(results, shape):
    world = results[0]
    n_depth = shape[2]
    sm = [res["softargmin"][shape]["softargmin"] for res in world]
    for rank, got in enumerate(sm):
        np.testing.assert_array_equal(got["split"], sm[0]["split"])
        np.testing.assert_allclose(got["split"], got["single"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.isnan(got["split"]), np.isnan(got["single"]))
        assert np.isnan(got["split"][0, 0, 0, 0]) and np.isfinite(got["split"][0, 0, 1, 0])
        # every rank differentiates the same merged depth: n_depth times the gradient
        grad = got["grad_split"] / n_depth
        np.testing.assert_array_equal(np.isnan(grad), np.isnan(got["grad_single"]))
        scale = np.nanmax(np.abs(got["grad_single"]))
        np.testing.assert_allclose(grad, got["grad_single"], rtol=1e-5, atol=1e-6 * scale)
    # the first block of pixel (0, 1) is all +inf: its triple is (-inf, 0, 0)
    assert np.isneginf(sm[0]["partial"][0, 0, 0, 1]) and (sm[0]["partial"][1:, 0, 0, 1] == 0).all()
    assert np.isfinite(sm[1]["partial"][:, 0, 0, 1]).all()


@pytest.mark.parametrize("fn", ["prob2depth", "upsample"])
@pytest.mark.parametrize("shape", OP_SHAPES)
def test_split_confidence_matches_one_process(results, shape, fn):
    world = results[0]
    for res in world:
        case = res["softargmin"][shape][fn]
        for got, want in zip(case["split"], case["single"]):
            assert got.shape == want.shape
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the seam pixel's estimate has bins on both sides of the seam, and a confidence of ~1
    conf = world[0]["softargmin"][shape]["prob2depth"]["split"][1]
    assert conf[1, 1, 1, 0] > 0.99


@pytest.mark.parametrize("shape", SHAPES)
def test_every_depth_rank_gets_the_same_outputs(results, shape):
    world, _, single, _ = results
    for res in world:
        out = res["forward"][shape]
        assert set(out) == set(single)
        for k in single:
            assert out[k].shape == single[k].shape, k
            np.testing.assert_array_equal(out[k], world[0]["forward"][shape][k], err_msg=k)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", SHAPES)
def test_depth_sharded_forward_matches_one_process(results, shape, key):
    world, _, single, _ = results
    tol = VOLUME_TOL if key == "refined_prob_volumes" else DEPTH_TOL
    np.testing.assert_allclose(world[0]["forward"][shape][key], single[key], **tol)


@pytest.mark.parametrize("key", ["depth", "depth_agg_initial"])
@pytest.mark.parametrize("shape", SHAPES)
def test_depth_sharded_forward_matches_jax(results, shape, key):
    world, jax_out, _, _ = results
    np.testing.assert_allclose(world[0]["forward"][shape][key], jax_out[key], **JAX_TOL)


def test_depth_estimator_on_a_depth_mesh(results):
    world, _, _, served = results
    for res in world:
        got = res["serving"]
        assert set(got) == set(served)
        np.testing.assert_allclose(got["depth"], served["depth"], rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(got["depth"], world[0]["serving"]["depth"])
