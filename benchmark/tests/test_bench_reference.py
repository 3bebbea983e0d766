"""The plain reference against the port on the CPU, at small sizes: the preparation of
frames and cams, the whole forward with confidence and upsampling, and the fusion.

    python -m pytest benchmark/tests -q
"""

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.reference import fusion as ref_fusion
from benchmark.reference import model as ref_model
from benchmark.reference import preprocess as ref_pre
from benchmark.reference.weights import load_weights

WEIGHTS = "artifacts/trained_demo/spheres_params.npz"


@pytest.fixture(autouse=True)
def _cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _request(h, w, views, seed):
    rig = scenes.render_rig(views, h, w, seed)
    return list(scenes.frames_uint8(rig)), list(scenes.rig_cams(rig, 128)), rig


@pytest.mark.parametrize("size", [(70, 100), (150, 210), (64, 96)])
def test_preparation_matches_the_port(size):
    from atvsnet_torch.data.preprocess import prepare_mvs_sample

    frames, cams, _ = _request(*size, 3, seed=5)
    got = ref_pre.prepare(frames, cams, 4, max_d=32, max_h=64, max_w=96)
    want = prepare_mvs_sample(frames, cams, 4, max_d=32, max_h=64, max_w=96, center=False)
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["cams"], want["cams"])
    assert got["valid_hw"] == want["valid_hw"]


@pytest.mark.parametrize("views,h,w,d,upsample", [(3, 64, 96, 16, True), (4, 64, 96, 32, False)])
def test_forward_matches_the_port(views, h, w, d, upsample):
    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.models.atvsnet import center_images, multi_view_forward
    from atvsnet_torch.params import load_model

    frames, cams, _ = _request(h, w, views, seed=11)
    prep = ref_pre.prepare(frames, cams, views, max_d=d, max_h=h, max_w=w)
    cfg = PipelineConfig(view_num=views, max_d=d, max_h=h, max_w=w)
    model = load_model(WEIGHTS, cfg, "cpu")
    images = torch.from_numpy(prep["images"])
    want = multi_view_forward(model, center_images(images), prep["cams"], cfg,
                              out_prob_map=True, upsample=upsample)
    got = ref_model.forward(load_weights(WEIGHTS, "cpu"), ref_model.center_images(images),
                            torch.from_numpy(prep["cams"]), d, upsample=upsample)
    keys = ["depth", "confidence"] + (["depth_up", "confidence_up"] if upsample else [])
    for k in keys:
        gap = (got[k] - want[k]).abs().max().item()
        # the same float32 operations in the same order: rounding noise, and none of the
        # refinement's discrete decisions flips at these inputs
        assert gap < 1e-4 * max(1.0, want[k].abs().max().item()), (k, gap)
    assert set(got) == set(keys)


def test_fusion_matches_the_port():
    from atvsnet_torch.fusion.consistency import fuse_depth_maps

    rig = scenes.render_rig(6, 60, 80, seed=3)
    depths = rig["depths"].copy()
    depths[:, ::7] = 0.0
    cams = scenes.rig_cams(rig, 128)
    images = scenes.frames_uint8(rig)
    want, _ = fuse_depth_maps(depths, images, cams, device="cpu")
    got = ref_fusion.fuse(depths, cams)
    assert want.shape[0] > 1000
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_confidence_filter():
    d = np.ones((2, 3), np.float32)
    p = np.array([[0.9, 0.5, 0.8], [0.79, 1.0, 0.0]], np.float32)
    np.testing.assert_array_equal(ref_fusion.confidence_filter(d, p),
                                  [[1, 0, 1], [0, 1, 0]])
