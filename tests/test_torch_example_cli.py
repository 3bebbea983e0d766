"""The example CLI of both packages on the same example/{i} directories and parameters.

The directories are written here (3 views, 64x96, D=32, rendered by
render_multiplane_scene, JPEG frames and cam npys with 1/4-scale intrinsics and an
inverse-depth sweep row). Both CLIs feed the frames raw (un-normalized BGR float32) and
run the trained spheres weights, fp32 on the CPU.

Tolerance: pred.npy holds metric depth in [1, 2]; the two agree to atol 1e-4 (measured
2e-6). The error reports are functions of pred.npy and agree to rtol 1e-3.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from atvsnet_tpu.cli import example as jax_cli
from atvsnet_torch.cli import example as port_cli
from atvsnet_torch.data.preprocess import load_example_dir
from atvsnet_torch.data.synthetic import render_multiplane_scene, write_example_dir

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
FILES = {"pred.npy", "pred.jpg", "error.xlsx", "error.json"}
D = 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two example directories (index 1 has no ground truth); run_examples of both
    packages over them, then a 5-view request that finds only 3 views."""
    root = tmp_path_factory.mktemp("example")
    for idx, seed in ((0, 11), (1, 12)):
        scene = render_multiplane_scene(view_num=3, H=64, W=96, D=D, seed=seed, num_spheres=2)
        write_example_dir(str(root / str(idx)), scene)
    os.remove(root / "1" / "0_gt.npy")
    out = {"root": root, "port": root / "out_port", "jax": root / "out_jax"}
    out["port_summary"] = port_cli.run_examples(str(root), [0, 1], 3, params_path=SPHERES,
                                                savepath=str(out["port"]), max_d=D, device="cpu")
    out["jax_summary"] = jax_cli.run_examples(str(root), [0, 1], 3, params_path=SPHERES,
                                              savepath=str(out["jax"]), max_d=D)
    out["fallback"] = port_cli.run_example(str(root), 0, 5, params_path=SPHERES,
                                           savepath=str(root / "out_fallback"), max_d=D, device="cpu")
    return out


@pytest.mark.parametrize("idx", [0, 1])
def test_pred_agrees_and_same_files_exist(runs, idx):
    port_dir, jax_dir = runs["port"] / str(idx), runs["jax"] / str(idx)
    expected = FILES if idx == 0 else {"pred.npy", "pred.jpg"}
    assert set(os.listdir(port_dir)) == set(os.listdir(jax_dir)) == expected
    got, ref = np.load(port_dir / "pred.npy"), np.load(jax_dir / "pred.npy")
    assert got.shape == ref.shape == (64, 96) and got.dtype == ref.dtype == np.float32
    assert np.isfinite(got).all() and got.min() > 0.9 and got.max() < 2.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_error_reports_and_summary(runs):
    with open(runs["port"] / "0" / "error.json") as f:
        got = json.load(f)
    with open(runs["jax"] / "0" / "error.json") as f:
        ref = json.load(f)
    assert list(got) == list(ref) and len(got) == 14
    for key in ref:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-3, atol=1e-6, err_msg=key)
    # the trained weights recover the rendered scene: mean error under 5% of its depth
    assert got["abs_relative"] < 0.05
    with open(runs["port"] / "examples_summary.json") as f:
        summary = json.load(f)
    assert set(summary) == set(runs["jax_summary"]) == {"0", "1"}
    assert summary["0"]["errors"] == runs["port_summary"]["0"]["errors"] == got
    assert "errors" not in summary["1"] and "errors" not in runs["jax_summary"]["1"]
    assert summary["0"]["runtime_s"] > 0 and summary["0"]["first_call_s"] > 0


def test_view_fallback_continues_with_the_views_found(runs):
    """view_num=5 on a 3-view directory runs the 3-view forward, as the 3-view call does."""
    np.testing.assert_array_equal(np.load(runs["root"] / "out_fallback" / "pred.npy"),
                                  np.load(runs["port"] / "0" / "pred.npy"))
    assert "errors" in runs["fallback"]


def test_two_view_switch_and_random_weights(runs, tmp_path):
    """2 views go through two_view_forward; without --params the weights are random and
    the outputs structurally valid."""
    root = runs["root"]
    two = root / "two"
    os.makedirs(two / "0", exist_ok=True)
    for name in ("0.jpg", "0_cam.npy", "1.jpg", "1_cam.npy", "0_gt.npy"):
        with open(root / "0" / name, "rb") as src, open(two / "0" / name, "wb") as dst:
            dst.write(src.read())
    got = port_cli.run_example(str(two), 0, 2, params_path=SPHERES, savepath=str(tmp_path / "p"),
                               max_d=D, device="cpu")
    jax_cli.run_example(str(two), 0, 2, params_path=SPHERES, savepath=str(tmp_path / "j"), max_d=D)
    np.testing.assert_allclose(np.load(tmp_path / "p" / "pred.npy"),
                               np.load(tmp_path / "j" / "pred.npy"), rtol=0, atol=1e-4)
    assert np.isfinite(list(got["errors"].values())).all()
    rnd = port_cli.run_example(str(two), 0, 2, savepath=str(tmp_path / "r"), max_d=D, seed=3,
                               device="cpu")
    assert set(os.listdir(tmp_path / "r")) == FILES
    assert np.isfinite(np.load(tmp_path / "r" / "pred.npy")).all() and "errors" in rnd


def test_frames_stay_raw(runs):
    """load_example_dir hands over un-normalized BGR float32 frames, and run_example does
    not center them: centering them by hand changes the prediction."""
    images, cams, gt = load_example_dir(str(runs["root"] / "0"), 3)
    assert images.dtype == np.float32 and images.max() > 100 and gt.shape == (64, 96)
    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.models.atvsnet import center_images, multi_view_forward, sweep_to_depth
    from atvsnet_torch.params import load_model

    cfg = PipelineConfig(view_num=3, max_d=D)
    model = load_model(SPHERES, cfg, device="cpu")
    raw = sweep_to_depth(multi_view_forward(model, images, cams, cfg)["depth_up"]).numpy().squeeze()
    np.testing.assert_array_equal(raw, np.load(runs["port"] / "0" / "pred.npy"))
    centered = multi_view_forward(model, center_images(torch.from_numpy(images)), cams, cfg)
    assert np.abs(sweep_to_depth(centered["depth_up"]).numpy().squeeze() - raw).max() > 1e-6


def test_main_parses_its_flags(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "example", "--root_path", str(runs["root"]), "--example_index", "0", "--view_num", "3",
        "--params", SPHERES, "--savepath", str(tmp_path / "m"), "--max_d", str(D), "--device", "cpu"])
    port_cli.main()
    np.testing.assert_array_equal(np.load(tmp_path / "m" / "pred.npy"),
                                  np.load(runs["port"] / "0" / "pred.npy"))
    monkeypatch.setattr(sys, "argv", ["example", "--root_path", str(runs["root"]), "--params",
                                      str(tmp_path / "none.npz"), "--example_index", "0",
                                      "--view_num", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not found"):
        port_cli.main()
