"""Worlds of gloo processes on the CPU for the port's multi-device tests.

run_world(tmp_path, size, fn, *args) spawns `size` processes, starts a gloo process group
in each from a FileStore under tmp_path (TCP ports would collide between test workers),
runs fn(*args) in each and returns their results in rank order. A rank that raises
fails the call with its traceback; so does one that gives no result in time.

Each rank keeps to one thread and switches oneDNN off (its CPU convolution backward
corrupted the heap with more than one thread, torch 2.13.0+cpu). This module imports
torch and the port only: the ranks never import JAX.
"""

from __future__ import annotations

import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RESULT_TIMEOUT_S = 120


def _rank_main(rank: int, size: int, store_path: str, results, fn, args):
    try:
        torch.set_num_threads(1)
        torch.backends.mkldnn.enabled = False
        store = dist.FileStore(store_path, size)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=size)
        try:
            results.put((rank, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_world(tmp_path, size: int, fn, *args) -> list:
    """[fn(*args) on rank 0, ..., on rank size - 1], each run in its own process."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(str(tmp_path), f"store_{fn.__name__}_{size}")
    procs = [ctx.Process(target=_rank_main, args=(r, size, store_path, results, fn, args))
             for r in range(size)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(size):
            rank, status, value = results.get(timeout=RESULT_TIMEOUT_S)
            (got.__setitem__(rank, value) if status == "ok" else errors.append(f"rank {rank}:\n{value}"))
            if errors:
                break
    except queue.Empty:
        errors.append(f"{size - len(got)} rank(s) gave no result in {RESULT_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [got[r] for r in range(size)]


def numpy_tree(x):
    """Tensors of a nested dict / list as numpy arrays (what a rank sends back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    return x


# ---- the cases the ranks run (each returns numpy trees) ----

def mesh_cases():
    """make_mesh's checks and layout on a world of 2, and AAM over the view group against
    AAM on all views in one process, forward and backward, on every rank."""
    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.nn.aam import attention_aggregate_stacked
    from atvsnet_torch.params import init_model
    from atvsnet_torch.parallel.mesh import gather_blocks, make_mesh

    res = {"errors": {}}
    for name, shape in (("world_size", (2, 2)), ("depth_axis", (1, 2, 2))):
        try:
            make_mesh(*shape, device="cpu")
        except (ValueError, NotImplementedError) as e:
            res["errors"][name] = f"{type(e).__name__}: {e}"
    mesh = make_mesh(1, 2, device="cpu")
    res["layout"] = {"n_data": mesh.n_data, "n_view": mesh.n_view, "data_rank": mesh.data_rank,
                     "view_rank": mesh.view_rank, "pairs": list(mesh.pair_block(4)),
                     "rows": mesh.data_rows(list(range(6))),
                     "groups": (mesh.data_group is None, mesh.view_group is None)}
    by_data = make_mesh(2, 1, device="cpu")
    res["layout_data"] = {"data_rank": by_data.data_rank, "rows": by_data.data_rows(list(range(6))),
                          "pairs": list(by_data.pair_block(4))}

    cfg = PipelineConfig(view_num=5, max_d=8, max_h=32, max_w=32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, 8, 8, 8, cfg.crm_base_filter), generator=g)
    r = torch.randn((1, 8, 8, 8, cfg.crm_base_filter), generator=g)
    for case, group, views in (("single", None, range(4)),
                               ("sharded", mesh.view_group, mesh.pair_block(4))):
        att = init_model(cfg, seed=1, device="cpu").aam1_att.requires_grad_(True)
        xl = x[views.start:views.stop].clone().requires_grad_(True)
        out = attention_aggregate_stacked(att, xl, group)
        (out * r).sum().backward()
        res[case] = {"out": out, "x_grad": xl.grad, "w_unique": att.weight_unique.grad,
                     "w_shared": att.weight_shared.grad}
    # gather_blocks: rank order, and each block's gradient summed over the ranks
    own = torch.full((1, 3), float(mesh.view_rank + 1), requires_grad=True)
    gathered = gather_blocks(own, mesh.view_group)
    (gathered * torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])).sum().backward()
    res["gather"] = {"value": gathered, "grad": own.grad}
    return numpy_tree(res)


def forward_cases(shapes, cfg_kw, tree, images, cams):
    """parallel.pipeline.sharded_forward of the whole batch on each mesh shape."""
    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.params import load_model
    from atvsnet_torch.parallel.mesh import make_mesh
    from atvsnet_torch.parallel.pipeline import sharded_forward

    cfg = PipelineConfig(**cfg_kw)
    model = load_model(tree, cfg, device="cpu")
    return {shape: numpy_tree(sharded_forward(make_mesh(*shape, device="cpu"), cfg)(
        model, images, cams)) for shape in shapes}


def train_cases(shapes, cfg_kw, params_path, batch):
    """loss_and_grads and one sharded_train_step of the whole batch on each mesh shape."""
    from atvsnet_torch.config import PipelineConfig, TrainConfig
    from atvsnet_torch.models.train import (init_train_state, loss_and_grads, make_optimizer,
                                            sharded_train_step)
    from atvsnet_torch.params import load_model
    from atvsnet_torch.parallel.mesh import make_mesh

    cfg, tcfg = PipelineConfig(**cfg_kw), TrainConfig()
    res = {}
    for shape in shapes:
        mesh = make_mesh(*shape, device="cpu")
        model = load_model(params_path, cfg, device="cpu").requires_grad_(True)
        loss, metrics, grads = loss_and_grads(model, batch, cfg, tcfg, mesh)
        opt = make_optimizer(tcfg)
        state = init_train_state(load_model(params_path, cfg, device="cpu"), opt)
        state, step_metrics = sharded_train_step(mesh, cfg, tcfg, opt)(state, batch)
        res[shape] = numpy_tree({"loss": loss, "metrics": metrics, "grads": grads,
                                 "step_metrics": step_metrics,
                                 "params": dict(state.model.named_parameters())})
    return res


def serving_cases(spec, cfg_kw, requests):
    """DepthEstimator(mesh=spec): predict, predict_many and a two-view estimator on the
    same mesh, with seeded weights."""
    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.serving import DepthEstimator

    def maps(r):
        return {k: v for k, v in r.items() if isinstance(v, np.ndarray)}

    est = DepthEstimator(PipelineConfig(**cfg_kw), seed=0, device="cpu", mesh=spec)
    two = DepthEstimator(PipelineConfig(**dict(cfg_kw, view_num=2)), seed=0, mesh=est.mesh)
    return {"predict": maps(est.predict(*requests[0])),
            "predict_many": [maps(r) for r in est.predict_many(requests)],
            "two_view": maps(two.predict(requests[0][0][:2], requests[0][1][:2])),
            "device": str(two.device)}


def eval_cases(data_root, savepath, params_path, scenes, eval_kw):
    """run_eval_pc(mesh="data=2"), then fuse_scene on rank 0 once every rank is done."""
    from atvsnet_torch.cli.eval_pointcloud import run_eval_pc
    from atvsnet_torch.fusion.fuse import fuse_scene

    run_eval_pc(data_root, savepath, scenes, params_path=params_path, device="cpu",
                mesh="data=2", **eval_kw)
    if dist.get_rank() == 0:
        return [fuse_scene(os.path.join(savepath, s), device="cpu") for s in scenes]
    return None


def several(*calls):
    """Several of the cases above in one world: [fn(*args) for each (fn, args)]."""
    return [fn(*args) for fn, args in calls]
