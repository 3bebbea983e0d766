"""The port's DepthEstimator on a mesh (mesh="data=2" and mesh="view=2") on gloo worlds of
2 processes on the CPU, against the JAX package's DepthEstimator on one device with the
same weights (the port's seeded random weights, carried over by export_jax_params): the
cases of tests/test_serving.py's meshed estimators (predict, predict_many padded to the
'data' extent, the two-view bucket) at its size, 3 views, 32x32, D=8.

Every rank returns the same results, to the bit. Against JAX, tests/test_torch_serving.py's
bounds: metric depths in [1, 4] rtol 1e-5, atol 1e-4; confidences atol 1e-4 where the
depth index is at least 1e-3 away from an integer.
"""

import threading

import numpy as np
import pytest

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.serving import DepthEstimator as JaxEstimator
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.params import export_jax_params, init_model

from tests._torch_world import run_world, serving_cases
from tests.test_torch_serving import _assert_matches_jax, _scene_arrays

KW = dict(view_num=3, max_d=8, max_h=32, max_w=32)
SPECS = ["data=2", "view=2"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The worlds' results, and JAX's, computed in a thread while the worlds run."""
    requests = [_scene_arrays(3, 32, 32, 8, seed=s) for s in (4, 5, 6)]
    tree = _unflatten(export_jax_params(init_model(PipelineConfig(**KW), seed=0, device="cpu")))
    ref = {}

    def jax_reference():
        jest = JaxEstimator(JaxConfig(**KW), params=tree)
        jtwo = JaxEstimator(JaxConfig(**dict(KW, view_num=2)), params=tree)
        ref.update(predict=jest.predict(*requests[0]), predict_many=jest.predict_many(requests),
                   two_view=jtwo.predict(requests[0][0][:2], requests[0][1][:2]))

    thread = threading.Thread(target=jax_reference)
    thread.start()
    try:
        root = tmp_path_factory.mktemp("serving")
        worlds = {spec: run_world(root, 2, serving_cases, spec, KW, requests) for spec in SPECS}
    finally:
        thread.join()
    return worlds, ref


def _maps_only(r):
    return {k: v for k, v in r.items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("spec", SPECS)
def test_ranks_return_the_same_results(results, spec):
    worlds, _ = results
    a, b = worlds[spec]
    for case in ("predict", "two_view"):
        assert a[case].keys() == b[case].keys()
        for k in a[case]:
            np.testing.assert_array_equal(a[case][k], b[case][k])
    assert len(a["predict_many"]) == len(b["predict_many"]) == 3
    assert a["device"] == "cpu"


@pytest.mark.parametrize("case", ["predict", "two_view"])
@pytest.mark.parametrize("spec", SPECS)
def test_predict_matches_jax(results, spec, case):
    worlds, ref = results
    got = dict(worlds[spec][0][case], bucket=ref[case]["bucket"])
    _assert_matches_jax(got, dict(_maps_only(ref[case]), bucket=ref[case]["bucket"]))


@pytest.mark.parametrize("spec", SPECS)
def test_predict_many_pads_and_matches_jax(results, spec):
    worlds, ref = results
    many = worlds[spec][0]["predict_many"]
    assert len(many) == 3                   # the padding row is not returned
    for got, want in zip(many, ref["predict_many"]):
        _assert_matches_jax(dict(got, bucket=want["bucket"]),
                            dict(_maps_only(want), bucket=want["bucket"]))
