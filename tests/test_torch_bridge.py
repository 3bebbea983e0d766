"""The port's package rules and its weight bridge.

  * atvsnet_torch (and chip_smoke.py) import neither jax nor atvsnet_tpu, nor optax or
    orbax, and every module of the port is there, the training slice's included;
  * the bridge round-trips the JAX package's init_params bit-exactly for every golden
    config and loads the committed trained weights;
  * the port's copy of the numpy scene generator equals the original.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from atvsnet_tpu.config import PipelineConfig as JaxConfig
from atvsnet_tpu.data import synthetic as jsyn
from atvsnet_tpu.models.tvsnet import init_params
from atvsnet_torch import resolve_device
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data import synthetic as tsyn
from atvsnet_tpu.utils.ckpt import load_params as jax_load_params
from atvsnet_tpu.utils.ckpt import save_params as jax_save_params
from atvsnet_torch.params import export_jax_params, flatten, init_model, load_model, save_params

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPHERES = os.path.join(ROOT, "artifacts", "trained_demo", "spheres_params.npz")
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_golden import golden_cases  # noqa: E402

DROPPED = {"scoped_vmem_kib"}   # TPU only; the quantization and fp32_precision are ported


def _port_cfg(jcfg) -> PipelineConfig:
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    return PipelineConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


def test_no_jax_in_the_port():
    code = (
        "import importlib, pkgutil, sys\n"
        "import atvsnet_torch\n"
        "for m in pkgutil.walk_packages(atvsnet_torch.__path__, 'atvsnet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'atvsnet_tpu'))\n"
        "assert not bad, bad\n"
        "need = ['serving', 'cli.example', 'cli.eval_errors', 'data.preprocess', 'data.image_io',\n"
        "        'data.cams', 'data.pfm', 'data.mvs_list', 'eval.errors', 'utils.xlsx', 'utils.log',\n"
        "        'fusion.ply', 'fusion.dmb', 'fusion.consistency', 'fusion.fuse', 'native',\n"
        "        'data.gipuma_io', 'data.colmap', 'data.mvs_syn', 'geometry.visual_hull',\n"
        "        'cli.eval_pointcloud', 'cli.depth_fusion', 'cli.reproduce_pc', 'utils.transfer',\n"
        "        'models.train', 'utils.ckpt', 'data.augment', 'data.colmap_train', 'cli.train']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "missing = [m for m in need if 'atvsnet_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('clean', len([m for m in sys.modules if m.startswith('atvsnet_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_config_fields_and_validation():
    jfields = {f.name for f in dataclasses.fields(JaxConfig)}
    tfields = {f.name for f in dataclasses.fields(PipelineConfig)}
    assert tfields == jfields - DROPPED
    for bad in ({"max_d": 12}, {"max_h": 100}, {"view_num": 1}, {"softargmin_impl": "pallas"},
                {"compute_dtype": "float16"}, {"act_quant": "int8x"}, {"warp_quant": "int8s"}):
        with pytest.raises(ValueError):
            PipelineConfig(**bad)
    assert PipelineConfig(compute_dtype="bfloat16").dtype == torch.bfloat16
    assert PipelineConfig(act_quant="int8mxu").act_quant == "int8mxu"


def test_default_device_is_cuda_never_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("case", [c[0] for c in golden_cases()])
def test_bridge_roundtrips_init_params(case):
    _, jcfg, _ = next(c for c in golden_cases() if c[0] == case)
    tree = flatten(jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg)))
    model = load_model(tree, _port_cfg(jcfg), device="cpu")
    back = export_jax_params(model)
    assert back.keys() == tree.keys()
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)
    # conv kernels land in PyTorch's (out, in, k...) layout, deconvs in (in, out, k...)
    assert tuple(model.fem.conv0_0.w.shape) == (jcfg.fem_base_filter, 3, 3, 3)
    crm_f = jcfg.crm_base_filter
    assert tuple(model.crm.conv_b0_4_0.w.shape) == (8 * crm_f, 4 * crm_f, 3, 3, 3)


def test_loads_trained_spheres_params():
    model = load_model(SPHERES, PipelineConfig(), device="cpu")
    params = list(model.parameters())
    assert len(params) == 208
    assert sum(p.numel() for p in params) == 3_272_059
    with np.load(SPHERES) as z:
        back = export_jax_params(model)
        for k in z.files:
            np.testing.assert_array_equal(back[k], z[k], err_msg=k)
    with pytest.raises(KeyError):
        load_model({"fem/conv0_0/w": np.zeros((3, 3, 3, 32), np.float32)}, PipelineConfig(),
                   device="cpu")


def test_save_params_roundtrip_through_jax(tmp_path):
    """save_params writes the JAX package's flat .npz: its load_params reads the tree back,
    and what its save_params writes from that tree loads into an equal model."""
    cfg = PipelineConfig(view_num=3, max_d=8, max_h=32, max_w=32)
    model = init_model(cfg, seed=5, device="cpu")
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    # another seed gives other weights, the same seed the same ones
    other = export_jax_params(init_model(cfg, seed=6, device="cpu"))
    same = export_jax_params(init_model(cfg, seed=5, device="cpu"))
    ours = export_jax_params(model)
    assert any(not np.array_equal(other[k], ours[k]) for k in ours)
    assert all(np.array_equal(same[k], ours[k]) for k in ours)

    save_params(str(tmp_path / "port"), model)                  # ".npz" is appended
    tree = jax_load_params(str(tmp_path / "port.npz"))
    assert set(tree) == {"fem", "fem_shallow", "crm", "refine", "aam1_att", "aam1_out",
                         "aam2_att", "aam2_out"}
    flat = flatten(jax.tree_util.tree_map(np.asarray, tree))
    assert flat.keys() == ours.keys()
    for k in ours:
        np.testing.assert_array_equal(flat[k], ours[k], err_msg=k)
    jax_save_params(str(tmp_path / "jax.npz"), tree)
    back = export_jax_params(load_model(str(tmp_path / "jax.npz"), cfg, device="cpu"))
    for k in ours:
        np.testing.assert_array_equal(back[k], ours[k], err_msg=k)


def test_synthetic_copy_matches_original():
    for a, b in zip(tsyn.synthetic_scene(view_num=3, H=32, W=64, D=8, seed=5),
                    jsyn.synthetic_scene(view_num=3, H=32, W=64, D=8, seed=5)):
        np.testing.assert_array_equal(a, b)
    kw = dict(view_num=3, H=32, W=48, D=8, seed=2, num_spheres=2)
    ta, ja = tsyn.render_multiplane_scene(**kw), jsyn.render_multiplane_scene(**kw)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
