"""The port's DepthEstimator: the cases of tests/test_serving.py that need no mesh, each
also held against the JAX package's DepthEstimator on the same frames, cams and
parameters (the port's random weights, carried over by export_jax_params).

Sizes: 3 views, 32x32 (a second bucket at 64x64), D=8, fp32, device="cpu" with the plain
soft-argmin. Tolerance against JAX: metric depths in [1, 4] agree to atol 1e-4, rtol
1e-5 (measured up to 3.2e-5 where a request is resized or padded); confidences, sums of
four softmax bins, to atol 1e-4, compared only where the depth index is at least 1e-3
away from an integer, since probability_map is discontinuous there.
"""

import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.data.synthetic import synthetic_scene
from atvsnet_tpu.serving import DepthEstimator as JaxEstimator
from atvsnet_tpu.utils.ckpt import _unflatten
from atvsnet_torch.cli.example import run_example
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.models.atvsnet import multi_view_forward, sweep_to_depth
from atvsnet_torch.params import export_jax_params, save_params
from atvsnet_torch.serving import DepthEstimator

torch.set_num_threads(2)

KW = dict(view_num=3, max_d=8, max_h=32, max_w=32)
DEPTH_TOL = dict(rtol=1e-5, atol=1e-4)
MAPS = ("depth", "depth_up", "confidence", "confidence_up")


def _scene_arrays(view_num, H, W, D, seed=3):
    """Raw (pre-normalization) images + metric-depth cams for the serving input."""
    rng = np.random.RandomState(seed)
    images = [rng.randint(0, 255, size=(H, W, 3)).astype(np.uint8) for _ in range(view_num)]
    cams = []
    for v in range(view_num):
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.eye(4)
        # off-axis baselines keep the warp's sample points off the pixel lattice: with a
        # pure x shift the rows land exactly on integers, and rounding alone then decides
        # whether a border sample counts as inside the image
        cam[0, :2, 3] = (0.02 * v, 0.011 * v)
        cam[1, :3, :3] = np.array([[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]])
        cam[1, 3] = (1.0, 3.0 / D, D, 4.0)  # metric range [1, 4], D planes
        cams.append(cam)
    return images, cams


def _away_from_bins(depth, D=8, lo=1.0, hi=4.0, margin=1e-3):
    """Pixels whose inverse-depth index is not within `margin` of an integer."""
    start, interval = 1.0 / hi, (1.0 / lo - 1.0 / hi) / D
    idx = (1.0 / np.maximum(depth, 1e-6) - start) / interval
    return np.abs(idx - np.round(idx)) > margin


def _assert_matches_jax(got, ref):
    assert got["bucket"] == ref["bucket"]
    assert set(got) == set(ref)
    for key in MAPS:
        if key not in ref:
            continue
        assert got[key].shape == ref[key].shape and got[key].dtype == np.float32
        if key.startswith("depth"):
            np.testing.assert_allclose(got[key], ref[key], **DEPTH_TOL, err_msg=key)
        else:
            ok = _away_from_bins(ref["depth" + key[len("confidence"):]])
            assert ok.mean() > 0.9
            np.testing.assert_allclose(got[key][ok], ref[key][ok], rtol=0, atol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def pair():
    """The port's estimator with two buckets, and the JAX estimator on the same weights."""
    est = DepthEstimator(PipelineConfig(**KW), seed=0, device="cpu")
    jest = JaxEstimator(JaxConfig(**KW), params=_unflatten(export_jax_params(est.model)))
    est.add_bucket(max_h=64, max_w=64)
    jest.add_bucket(max_h=64, max_w=64)
    return est, jest


class TestDepthEstimator:
    def test_predict_shapes_and_finiteness(self, pair):
        est, jest = pair
        images, cams = _scene_arrays(3, 32, 32, 8)
        out = est.predict(images, cams)
        assert out["depth"].shape == (8, 8)
        assert out["depth_up"].shape == (32, 32)
        assert out["confidence"].shape == (8, 8)
        assert out["confidence_up"].shape == (32, 32)
        assert np.isfinite(out["depth"]).all() and np.isfinite(out["depth_up"]).all()
        # metric depth within the sweep's metric range
        assert (out["depth"] >= 0).all() and (out["depth"] <= 4.0 + 1e-3).all()
        assert out["runtime_s"] > 0
        _assert_matches_jax(out, jest.predict(images, cams))

    def test_view_padding_fallback(self, pair):
        """Fewer views than cfg.view_num pad with the reference view."""
        est, jest = pair
        images, cams = _scene_arrays(2, 32, 32, 8)
        out = est.predict(images, cams)
        assert np.isfinite(out["depth"]).all()
        _assert_matches_jax(out, jest.predict(images, cams))

    def test_extra_views_are_truncated(self, pair):
        est, jest = pair
        images, cams = _scene_arrays(5, 32, 32, 8)
        out = est.predict(images, cams)
        np.testing.assert_array_equal(out["depth"], est.predict(images[:3], cams[:3])["depth"])
        _assert_matches_jax(out, jest.predict(images, cams))

    @pytest.mark.parametrize("hw", [(24, 24), (31, 17)])
    def test_small_input_pad_and_mask(self, pair, hw):
        """Inputs smaller than the bucket run padded and come back cropped: int(v * 0.25)
        rows and columns at cost-volume resolution, v at full resolution."""
        est, jest = pair
        images, cams = _scene_arrays(3, *hw, 8)
        out = est.predict(images, cams)
        assert out["bucket"] == (32, 32)
        assert out["depth_up"].shape == hw
        assert out["depth"].shape == (hw[0] // 4, hw[1] // 4)
        assert out["confidence"].shape == out["depth"].shape
        _assert_matches_jax(out, jest.predict(images, cams))

    def test_repeat_calls_agree(self, pair):
        est, _ = pair
        images, cams = _scene_arrays(3, 32, 32, 8, seed=5)
        a = est.predict(images, cams)
        b = est.predict(images, cams)
        np.testing.assert_array_equal(a["depth"], b["depth"])
        assert a["depth"] is not b["depth"]          # each call owns its downloaded row

    def test_matches_pipeline_on_preprocessed(self, pair):
        """preprocessed=True bypasses host prep and matches multi_view_forward."""
        est, jest = pair
        images, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=7)
        out = est.predict(list(images[0]), list(cams[0]), preprocessed=True)
        ref = multi_view_forward(est.model, images, cams, est.cfg, out_prob_map=True)
        np.testing.assert_allclose(out["depth"], sweep_to_depth(ref["depth"])[0, ..., 0].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["confidence_up"], ref["confidence_up"][0, ..., 0].numpy(),
                                   rtol=1e-6, atol=1e-6)
        jout = jest.predict(list(images[0]), list(cams[0]), preprocessed=True)
        np.testing.assert_allclose(out["depth"], jout["depth"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["depth_up"], jout["depth_up"], rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("hw,bucket,depth_shape", [
        ((32, 32), (32, 32), (8, 8)),
        ((48, 48), (64, 64), (12, 12)),       # padded up into the 64-bucket, cropped back
        ((96, 96), (64, 64), (16, 16)),       # no bucket fits: downscaled into the largest
        ((50, 70), (64, 64), (12, 16)),       # padded in height, center-cropped in width
    ])
    def test_bucket_routing(self, pair, hw, bucket, depth_shape):
        est, jest = pair
        assert len(est.buckets) == 2
        images, cams = _scene_arrays(3, *hw, 8)
        out = est.predict(images, cams)
        assert out["bucket"] == bucket and out["depth"].shape == depth_shape
        _assert_matches_jax(out, jest.predict(images, cams))
        est.add_bucket(max_h=64, max_w=64)           # registering again changes nothing
        assert len(est.buckets) == 2

    def test_predict_many_matches_predict(self, pair):
        """predict_many batches distinct requests through one forward, and each result
        equals its single-request predict() (statistics are per sample)."""
        est, jest = pair
        reqs = [_scene_arrays(3, 32, 32, 8, seed=1), _scene_arrays(3, 24, 28, 8, seed=2),
                _scene_arrays(2, 32, 32, 8, seed=3)]
        many = est.predict_many(reqs)
        jmany = jest.predict_many(reqs)
        assert len(many) == 3
        for (images, cams), got, ref in zip(reqs, many, jmany):
            one = est.predict(images, cams)
            for key in MAPS:
                np.testing.assert_allclose(got[key], one[key], rtol=1e-5, atol=1e-5, err_msg=key)
            _assert_matches_jax(got, ref)
        assert many[1]["depth_up"].shape == (24, 28)
        assert est.predict_many([]) == []

    def test_predict_paths(self, pair, tmp_path):
        import cv2

        from atvsnet_torch.data.cams import write_cam

        est, jest = pair
        images, cams = _scene_arrays(3, 32, 32, 8, seed=9)
        paths = []
        for v, (im, cam) in enumerate(zip(images, cams)):
            cam = cam.copy()
            cam[1, 3] = (1.0, 3.0 / 8, 8, 0)         # text cams carry start and interval
            paths += [str(tmp_path / f"{v}.png"), str(tmp_path / f"{v}_cam.txt")]
            cv2.imwrite(paths[-2], im)
            write_cam(paths[-1], cam)
        _assert_matches_jax(est.predict_paths(paths), jest.predict_paths(paths))
        with pytest.raises(FileNotFoundError):
            est.predict_paths([str(tmp_path / "none.png"), paths[1]])

    def test_warmup_runs_both_paths(self, pair):
        est, _ = pair
        assert est.warmup(all_buckets=True, include_pre=True) > 0


def test_two_view_estimator():
    kw = dict(view_num=2, max_d=8, max_h=32, max_w=32)
    est = DepthEstimator(PipelineConfig(**kw), seed=1, device="cpu")
    jest = JaxEstimator(JaxConfig(**kw), params=_unflatten(export_jax_params(est.model)))
    images, cams = _scene_arrays(2, 32, 32, 8)
    out = est.predict(images, cams)
    assert out["depth"].shape == (8, 8) and np.isfinite(out["depth_up"]).all()
    assert "confidence" not in out
    _assert_matches_jax(out, jest.predict(images, cams))


def test_without_confidence_packs_two_maps():
    est = DepthEstimator(PipelineConfig(**KW), seed=0, with_confidence=False, device="cpu")
    out = est.predict(*_scene_arrays(3, 32, 32, 8))
    assert set(out) == {"depth", "depth_up", "runtime_s", "bucket"}


def test_preprocessed_off_bucket_raises():
    est = DepthEstimator(PipelineConfig(**KW), device="cpu")
    images, cams = synthetic_scene(view_num=3, H=64, W=64, D=8, seed=0)
    with pytest.raises(ValueError, match="registered buckets"):
        est.predict(list(images[0]), list(cams[0]), preprocessed=True)
    images, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=0)
    mixed = [images[0][0], images[0][1][:16], images[0][2]]
    with pytest.raises(ValueError, match="all views must match"):
        est.predict(mixed, list(cams[0]), preprocessed=True)


def test_preprocessed_view_padding():
    est = DepthEstimator(PipelineConfig(**KW), device="cpu")
    images, cams = synthetic_scene(view_num=3, H=32, W=32, D=8, seed=11)
    out = est.predict(list(images[0][:2]), list(cams[0][:2]), preprocessed=True)
    assert np.isfinite(out["depth"]).all() and out["depth"].shape == (8, 8)


def test_bucket_key_covers_all_config_fields():
    """A bucket that differs in any field, shape or not, is a distinct bucket."""
    import dataclasses

    cfg = PipelineConfig(**KW)
    est = DepthEstimator(cfg, device="cpu")
    other = {"view_num": 2, "max_d": 16, "max_h": 64, "max_w": 64, "sample_scale": 0.5,
             "inverse_depth": False, "batch_size": 2, "compute_dtype": "bfloat16", "bn_eps": 1e-2,
             "remat": True, "pair_batch": True, "softargmin_impl": "torch",
             "reference_compat": True, "act_quant": "int8", "act_quant_range": 4.0,
             "warp_quant": "int8", "prob_threshold": 0.5, "disp_threshold": 0.1,
             "num_consistent": 3, "fusion_depth_min": 0.1, "fusion_depth_max": 10.0,
             "fusion_normal_threshold_deg": 90.0, "fp32_precision": "default"}
    widths = {"fem_base_filter", "crm_base_filter", "shallow_base_filter", "refine_base_filter"}
    assert set(other) | widths == {f.name for f in dataclasses.fields(PipelineConfig)}
    for n, (field, value) in enumerate(other.items(), start=2):
        c = est.add_bucket(**{field: value})
        assert getattr(c, field) == value and len(est.buckets) == n, field
        assert est.add_bucket(**{field: value}) == c and len(est.buckets) == n
    for field in widths:       # the one shared model cannot serve other widths
        with pytest.raises(ValueError, match="shares the estimator's model"):
            est.add_bucket(**{field: 4})


def test_inverse_depth_bucket_is_served_by_its_own_config():
    est = DepthEstimator(PipelineConfig(**KW), seed=0, device="cpu")
    images, cams = _scene_arrays(3, 32, 32, 8)
    inverse = est.predict(images, cams)["depth"]
    metric_only = DepthEstimator(PipelineConfig(inverse_depth=False, **KW), seed=0, device="cpu")
    assert np.abs(metric_only.predict(images, cams)["depth"] - inverse).max() > 1e-3


def test_default_device_is_the_gpu_and_params_sources(tmp_path):
    """Without device="cpu" the estimator and the CLI need CUDA; params, params_path and
    the seed give the same model when they describe the same weights."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DepthEstimator(PipelineConfig(**KW))
        with pytest.raises(RuntimeError, match="CUDA"):
            run_example(str(tmp_path), 0, 3)
    # a mesh needs a world: without torchrun's environment or a started process group,
    # make_mesh refuses (tests/test_torch_parallel_serving.py serves on gloo worlds)
    with pytest.raises(ValueError, match="RANK"):
        DepthEstimator(PipelineConfig(**KW), device="cpu", mesh="data=1,view=2")
    est = DepthEstimator(PipelineConfig(**KW), seed=4, device="cpu")
    path = str(tmp_path / "weights.npz")
    save_params(path, est.model)
    images, cams = _scene_arrays(3, 32, 32, 8)
    ref = est.predict(images, cams)["depth"]
    for kw in ({"params_path": path}, {"params": export_jax_params(est.model)},
               {"params": _unflatten(export_jax_params(est.model))}):
        other = DepthEstimator(PipelineConfig(**KW), device="cpu", **kw)
        np.testing.assert_array_equal(other.predict(images, cams)["depth"], ref)
