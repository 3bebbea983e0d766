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


def depth_op_cases(shape, depth_num=32, seed=0):
    """Each volume op on this rank's block of D planes of a mesh of `shape` (every data
    and view rank runs the same case over its depth group), and the same op on the whole
    volume in this process: the conv at stride 1 and 2, the transposed conv, conv3d_mixed
    at both strides, batch_stat_norm, conv_bn with int8 quantization. For each: the
    gathered outputs and both values of a seeded linear functional's gradient (the
    input's and the weight's; the split's summed over the depth group by the caller)."""
    from atvsnet_torch.nn import layers as L
    from atvsnet_torch.parallel.depth import DepthSplit
    from atvsnet_torch.parallel.mesh import gather_blocks, make_mesh

    mesh = make_mesh(*shape, device="cpu")
    split = DepthSplit.of(mesh, depth_num)
    g = torch.Generator().manual_seed(seed)
    B, h, w, C, Co = 2, 6, 5, 3, 4
    x = torch.randn((B, depth_num, h, w, C), generator=g)
    c2 = torch.randn((B, h, w, 2), generator=g)
    wk = torch.randn((Co, C, 3, 3, 3), generator=g) * 0.3
    wm = torch.randn((Co, C + 2, 3, 3, 3), generator=g) * 0.3
    wt = torch.randn((C, Co, 3, 3, 3), generator=g) * 0.3
    quant = L.ActQuant("int8")
    ops = {
        "conv s1": (lambda v, s, k: L.conv(v, k, split=s), wk),
        "conv s2": (lambda v, s, k: L.conv(v, k, stride=2, split=s), wk),
        "deconv": (lambda v, s, k: L.deconv(v, k, split=s), wt),
        "mixed s1": (lambda v, s, k: L.conv3d_mixed(k, v, c2, split=s), wm),
        "mixed s2": (lambda v, s, k: L.conv3d_mixed(k, v, c2, stride=2, split=s), wm),
        "batch_stat_norm": (lambda v, s, k: L.batch_stat_norm(v * v, split=s), wk),
        "conv_bn int8": (lambda v, s, k: L.conv_bn(v, k, quant=quant, split=s), wk),
    }
    res = {"offset": split.offset, "local": split.local}
    for name, (op, kernel) in ops.items():
        case = {}
        for which, sp in (("split", split), ("single", None)):
            xv = (x[:, split.planes] if sp is not None else x).clone().requires_grad_(True)
            kv = kernel.clone().requires_grad_(True)
            y = op(xv, sp, kv)
            r = torch.randn(y.shape[:1] + (y.shape[1] * (split.size if sp is not None else 1),)
                            + y.shape[2:], generator=torch.Generator().manual_seed(seed + 1))
            if sp is not None:
                r = r[:, y.shape[1] * split.rank:y.shape[1] * (split.rank + 1)]
            group = split.group if sp is not None else None
            case[which] = {"out": gather_blocks(y.detach(), group, dim=1)}
            if name != "conv_bn int8":      # the quantized link is inference only
                (y * r).sum().backward()
                case[which].update(x_grad=gather_blocks(xv.grad, group, dim=1),
                                   w_grad=torch.zeros_like(kv) if kv.grad is None else kv.grad)
        res[name] = case
    return numpy_tree(res)


def depth_softargmin_cases(shape, depth_num=32, seed=0):
    """The soft-argmin over a split D on a mesh of `shape` against the one-process
    versions on the whole volume: the merged depth and its gradient (SplitSoftArgminFunction
    on the plain partial forward and stats-fed backward) against softargmin_torch and
    autograd of it; the depth and 4-bin confidence of prob2depth(out_prob_map=True) and
    the upsampled soft-argmin, split against whole. The volume has a pixel whose planes
    are all +inf, one whose first block's planes are all +inf, and one whose estimate sits
    on the seam between two blocks."""
    from atvsnet_torch.geometry import depth_regression as R
    from atvsnet_torch.ops import softargmin as S
    from atvsnet_torch.parallel.depth import DepthSplit
    from atvsnet_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*shape, device="cpu")
    split = DepthSplit.of(mesh, depth_num)
    n_depth = split.size
    g = torch.Generator().manual_seed(seed)
    B, h, w = 2, 4, 6
    cost = torch.randn((B, depth_num, h, w), generator=g) * 3.0
    cost[0, :, 0, 0] = torch.inf                         # NaN depth
    cost[0, :depth_num // n_depth, 0, 1] = torch.inf     # the first block sees only +inf
    seam = depth_num // n_depth
    cost[1, :, 1, 1] = 40.0
    cost[1, seam - 1:seam + 1, 1, 1] = 0.0               # the estimate between two blocks
    start = torch.tensor([0.5, 1.0])
    interval = torch.tensor([0.05, 0.02])
    gd = torch.randn((B, h, w, 1), generator=g)
    res = {}
    local = cost[:, split.planes].clone().requires_grad_(True)
    depth = S.softargmin(local, depth_num, start, interval, impl="torch", split=split)
    depth.backward(gd)
    whole = cost.clone().requires_grad_(True)
    want = S.softargmin_torch(whole, start, interval)
    want.backward(torch.where(torch.isnan(want), 0.0, gd))
    res["softargmin"] = {"split": depth.detach(), "single": want.detach(),
                         "grad_split": local.grad, "grad_single": whole.grad[:, split.planes],
                         "partial": S.softargmin_partial_torch(local.detach(), start, interval,
                                                               split.offset)}
    for name, fn in (("prob2depth", lambda v, s: R.prob2depth(v, depth_num, start, interval,
                                                              True, split=s)),
                     ("upsample", lambda v, s: R.prob2depth_upsample(v, depth_num, start,
                                                                     interval, True, split=s))):
        res[name] = {"split": fn(cost[:, split.planes], split), "single": fn(cost, None)}
    return numpy_tree(res)


def depth_mesh_cases():
    """make_mesh with a 'depth' axis on a world of 4: the layout of (1, 2, 2) and
    (2, 1, 2), each rank's block of planes, and the errors."""
    from atvsnet_torch.parallel.depth import DepthSplit
    from atvsnet_torch.parallel.mesh import make_mesh

    res = {"errors": {}}
    for shape in ((1, 2, 2), (2, 1, 2)):
        mesh = make_mesh(*shape, device="cpu")
        split = DepthSplit.of(mesh, 16)
        res[shape] = {"ranks": (mesh.data_rank, mesh.view_rank, mesh.depth_rank),
                      "extents": (mesh.n_data, mesh.n_view, mesh.n_depth),
                      "names": mesh.device_mesh.mesh_dim_names,
                      "planes": (mesh.plane_block(16).start, mesh.plane_block(16).stop),
                      "split": (split.offset, split.local, split.is_first, split.is_last),
                      "groups": tuple(g is None for g in (mesh.data_group, mesh.view_group,
                                                          mesh.depth_group))}
    flat = make_mesh(2, 2, device="cpu")
    res["two_axes"] = {"names": flat.device_mesh.mesh_dim_names, "n_depth": flat.n_depth,
                       "depth_rank": flat.depth_rank, "split": DepthSplit.of(flat, 16)}
    for name, fn in (("world_size", lambda: make_mesh(1, 1, 3, device="cpu")),
                     ("uneven_planes", lambda: DepthSplit.of(make_mesh(1, 1, 4, device="cpu"), 16))):
        try:
            fn()
        except ValueError as e:
            res["errors"][name] = str(e)
    return res


def depth_serving_cases(shape, cfg_kw, request):
    """DepthEstimator on a built mesh with a 'depth' axis: predict of one request."""
    from atvsnet_torch.config import PipelineConfig
    from atvsnet_torch.parallel.mesh import make_mesh
    from atvsnet_torch.serving import DepthEstimator

    est = DepthEstimator(PipelineConfig(**cfg_kw), seed=0, device="cpu",
                         mesh=make_mesh(*shape, device="cpu"))
    return {k: v for k, v in est.predict(*request).items() if isinstance(v, np.ndarray)}


def several(*calls):
    """Several of the cases above in one world: [fn(*args) for each (fn, args)]."""
    return [fn(*args) for fn, args in calls]
