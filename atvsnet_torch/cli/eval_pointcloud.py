"""ETH3D point-cloud eval script (the port of atvsnet_tpu/cli/eval_pointcloud.py;
reference atvsnet/eval_pointcloud.py).

    python -m atvsnet_torch.cli.eval_pointcloud --data_root ../data --savepath ./eval_out \
        [--scenes lakeside sand_box ...] [--params model.npz] [--view_num 8] \
        [--batch 1] [--mesh data=2,view=4] [--gt_range] [--device cpu] \
        [--act-quant none|int8|int8s|int8mxu] [--warp-quant none|int8]

Per scene: parse pair.txt, per reference image run the N-view forward, write %08d.pfm
depth, %08d_prob.pfm confidence, ref jpg + cam txt, a viridis png, and zz_runtime.txt.
All inputs are padded/cropped to a single (max_h, max_w) bucket (the reference crops per
image), so every reference image of every scene goes through one shape.

How the work is laid out:
  - decode/scale/crop runs on a thread pool, several samples in flight (cv2 releases the
    GIL during imread/resize);
  - frames go up as uint8 and are normalized on the device; metric depth, confidence and
    sweep depth come down as ONE packed fp32 row per sample into pinned memory
    (serving.packed_forward, shared with DepthEstimator);
  - the main thread, the only one that touches the device, queues batch i+1 before it waits
    for batch i's download, so unpacking and handing out the writes overlap the device;
  - all file writes (PFM/jpg/cam/png) go to a writer pool; the loop never blocks on disk.

--batch B stacks B distinct reference images into one (B, N, H, W, 3) forward (pure data
batching; the reference loops B=1 always).

--mesh data=N[,view=M] runs the forward over a mesh of N * M processes (parallel.mesh),
one per device, started by torchrun:

    torchrun --nproc_per_node=2 -m atvsnet_torch.cli.eval_pointcloud --mesh data=2 ...

Each batch (rounded up to a multiple of N) is split over 'data': a data rank loads and
runs its own rows, and its view pairs are split over 'view'. Only view rank 0 of each
data group writes its rows' files, which are the files of an unsharded run; the call
returns on every rank once all of them are written. run_eval_pc also takes a built
parallel.mesh.Mesh, a 3-axis one with 'depth' too; then depth rank 0 writes.

--act-quant / --warp-quant store the volume links / the warped feature volumes on int8
lattices (PipelineConfig.act_quant, warp_quant; inference only); --act-quant int8mxu also
runs the volume convs that read such links on int8 operands. The default, none, is the
exact path.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from atvsnet_torch import resolve_device
from atvsnet_torch.cli.example import save_colormap
from atvsnet_torch.config import ACT_QUANT_MODES, WARP_QUANT_MODES, PipelineConfig
from atvsnet_torch.data import image_io
from atvsnet_torch.data.cams import write_cam
from atvsnet_torch.data.mvs_list import gen_pipeline_mvs_list
from atvsnet_torch.data.pfm import save_pfm
from atvsnet_torch.data.preprocess import load_mvs_sample
from atvsnet_torch.models.atvsnet import sweep_to_depth
from atvsnet_torch.params import init_model, load_model
from atvsnet_torch.parallel.mesh import Mesh, block, make_mesh, parse_mesh_spec
from atvsnet_torch.serving import packed_forward, unpack_rows
from atvsnet_torch.utils import log
from atvsnet_torch.utils.profiling import TRACER
from atvsnet_torch.utils.transfer import finish_download

ETH3D_SCENES = ["lakeside", "sand_box", "storage_room", "storage_room_2", "tunnel"]


def _write_sample_outputs(out_folder, sample, depth, conf, depth_sweep, sample_scale,
                          depth_sweep_up=None):
    """Write one ref image's artifacts (runs on a writer thread).

    depth/conf/depth_sweep: (h, w) float32 host arrays at cost-volume resolution;
    depth_sweep_up: optional 4x-upsampled sweep map for the reference-style viz PNG
    (the PNG falls back to the native map when the upsample was skipped).
    """
    vh, vw = sample["valid_hw"]
    vh4, vw4 = int(vh * sample_scale), int(vw * sample_scale)
    if (vh4, vw4) != depth.shape[:2]:
        depth = depth[:vh4, :vw4]
        conf = conf[:vh4, :vw4]
        depth_sweep = depth_sweep[:vh4, :vw4]
        if depth_sweep_up is not None:
            depth_sweep_up = depth_sweep_up[:vh, :vw]
    idx = sample["index"]
    save_pfm(os.path.join(out_folder, f"{idx:08d}.pfm"), depth.astype(np.float32))
    save_pfm(os.path.join(out_folder, f"{idx:08d}_prob.pfm"), conf.astype(np.float32))
    # ref image at cost-volume resolution + matching cams (the fusion inputs,
    # reference eval_pointcloud.py:380-388)
    ref_img = sample["images_raw"][0, 0]
    h, w = depth.shape[:2]
    image_io.imwrite(os.path.join(out_folder, f"{idx:08d}.jpg"), image_io.resize_to(ref_img, w, h))
    write_cam(os.path.join(out_folder, f"{idx:08d}.txt"), sample["cams"][0, 0])
    save_colormap(
        os.path.join(out_folder, f"{idx:08d}.png"),
        depth_sweep if depth_sweep_up is None else depth_sweep_up,
    )


def run_eval_pc(
    data_root: str,
    savepath: str,
    scenes,
    view_num: int = 8,
    max_d: int = 128,
    max_w: int = 896,
    max_h: int = 480,
    params_path: str | None = None,
    compute_dtype: str = "float32",
    seed: int = 0,
    batch: int = 1,
    load_workers: int = 6,
    write_workers: int = 2,
    gt_range: bool = False,
    full_viz: bool = False,
    device=None,
    mesh: str | Mesh | None = None,
    act_quant: str = "none",
    warp_quant: str = "none",
) -> dict:
    """Depth, confidence, reference jpg, cam and png of every reference image of `scenes`
    under <data_root>/eth3d/, written to <savepath>/<scene>/depths_atvsnet/. Runs on
    `device` (CUDA when None). Returns the run's own clock: seconds the main thread was
    blocked on loading, queueing the forwards, waiting for them and flushing the writes;
    seconds of each batch from before its upload until its download had landed; and each
    scene's wall seconds and maps per second. `mesh`: a spec such as "data=2,view=2" (see
    the module docstring), or a built Mesh; every rank of the mesh calls run_eval_pc
    alike. act_quant, warp_quant: PipelineConfig's storage quantization.

    Traced (utils.profiling.TRACER, while a profiler records): eval.startup from the entry
    until the first forward is queued, with eval.load_model and eval.first_load in it; then
    eval.load_wait, eval.forward and eval.drain of each batch, with the batch's index as
    their request id; last eval.write_flush. Each of these but eval.startup and
    eval.load_model is also its key of the returned clock's `blocked`.
    """
    startup = TRACER.span("eval.startup")
    startup.__enter__()
    try:
        if isinstance(mesh, str) and mesh:
            mesh = make_mesh(*parse_mesh_spec(mesh), device=device)
        if isinstance(mesh, Mesh):
            device = mesh.device
            if batch % mesh.n_data:
                batch = mesh.n_data * max(1, batch // mesh.n_data)
            log.info(f"mesh (data={mesh.n_data}, view={mesh.n_view}, depth={mesh.n_depth}), "
                     f"batch={batch}")
        else:
            mesh = None
        device = resolve_device(device)
        on_gpu = device.type == "cuda"
        max_h = (max_h // 32) * 32
        max_w = (max_w // 32) * 32
        cfg = PipelineConfig(
            view_num=view_num, max_d=max_d, max_h=max_h, max_w=max_w, compute_dtype=compute_dtype,
            act_quant=act_quant, warp_quant=warp_quant,
        )
        log.info(
            f"numerics: compute_dtype={compute_dtype} act_quant={act_quant} "
            f"warp_quant={warp_quant}, device {device}"
            + ("" if act_quant == "none" and warp_quant == "none"
               else " (quantized mode; pass --act-quant none --warp-quant none for the exact path)")
        )

        with TRACER.span("eval.load_model"):
            if params_path:
                if not os.path.exists(params_path):
                    raise SystemExit(f"error: --params checkpoint not found: {params_path}")
                model = load_model(params_path, cfg, device)
                log.info(f"params restored from {params_path}")
            else:
                log.warn("no --params given: using seeded random weights")
                model = init_model(cfg, seed, device)

        h, w = int(max_h * cfg.sample_scale), int(max_w * cfg.sample_scale)
        names, shapes = ["depth", "confidence", "depth_sweep"], [(h, w)] * 3
        if full_viz:
            names, shapes = names + ["depth_sweep_up"], shapes + [(max_h, max_w)]

        def maps_of(out):
            # ONLY what the script consumes comes down, metric conversion done on the device,
            # as one packed row. Upsampling runs only when the reference-style full-resolution
            # viz PNG is asked for: the PFMs are at native resolution either way (so are the
            # reference's; its *_up writes are commented out)
            parts = [sweep_to_depth(out["depth"], cfg.inverse_depth), out["confidence"],
                     out["depth"]]
            return parts + ([out["depth_up"]] if full_viz else [])

        os.makedirs(savepath, exist_ok=True)
        # bound in-flight decoded chunks (each is tens of MB at 8-view eval scale)
        window = max(2, (load_workers + batch - 1) // batch + 1)
        if batch > 1:
            # chunk workers only gather + concatenate; per-sample decode fans out to
            # its own pool so all load_workers decode even when a chunk holds many
            # samples (one worker decoding a whole chunk serially stalls scene starts)
            sample_pool = ThreadPoolExecutor(max_workers=max(1, load_workers))
            load_pool = ThreadPoolExecutor(max_workers=window)
        else:
            sample_pool = None
            load_pool = ThreadPoolExecutor(max_workers=max(1, load_workers))
        write_pool = ThreadPoolExecutor(max_workers=max(1, write_workers))

        def _load(paths):
            # center=False: raw uint8 goes up; the device normalizes
            return load_mvs_sample(
                paths, view_num, max_d=max_d, max_h=max_h, max_w=max_w,
                inverse_depth=cfg.inverse_depth, gt_range=gt_range, center=False,
            )

        # this rank's rows of each batch; only view (and depth) rank 0 of each data group writes
        rows = (range(batch) if mesh is None
                else range(batch)[block(batch, mesh.n_data, mesh.data_rank)])
        writer = mesh is None or (mesh.view_rank == 0 and mesh.depth_rank == 0)

        def _load_chunk(paths_chunk):
            """Decode+preprocess this rank's rows of a batch off the main thread, which then
            only touches ready arrays. The tail pads with the last sample."""
            n_real = len(paths_chunk)
            mine = [min(r, n_real - 1) for r in rows]
            unique = sorted(set(mine))
            paths = [paths_chunk[i] for i in unique]
            loaded = list(sample_pool.map(_load, paths)) if sample_pool is not None else [
                _load(p) for p in paths]
            samples = [loaded[unique.index(i)] for i in mine]
            images = np.concatenate([s["images"] for s in samples], axis=0)
            cams = np.concatenate([s["cams"] for s in samples], axis=0)
            return (images, cams), samples, sum(r < n_real for r in rows)

        # ---- one chunk stream across ALL scenes. Per-scene queues stall the loop at
        # every scene boundary (the first chunk of a scene has no decode lead time);
        # a flat stream keeps the loaders primed through boundaries. All scenes share the
        # one bucket, so only the output folder differs per chunk. ----
        scene_meta = []
        work = []  # (scene_index, [sample paths] of one batch)
        for scene in scenes:
            dense_path = os.path.join(data_root, "eth3d", scene)
            if not os.path.isdir(dense_path):
                log.warn(f"scene folder missing, skipping: {dense_path}")
                continue
            mvs_list = gen_pipeline_mvs_list(dense_path, view_num)
            out_folder = os.path.join(savepath, scene, "depths_atvsnet")
            os.makedirs(out_folder, exist_ok=True)
            si = len(scene_meta)
            scene_meta.append({
                "name": scene, "out_folder": out_folder, "n": len(mvs_list),
                "start": None, "end": 0.0, "done": 0, "write_futures": [],
            })
            for i in range(0, len(mvs_list), batch):
                work.append((si, mvs_list[i : i + batch]))

        queue = deque()
        next_i = 0

        def _top_up():
            nonlocal next_i
            while next_i < len(work) and len(queue) < window:
                si, chunk = work[next_i]
                queue.append((si, load_pool.submit(_load_chunk, chunk)))
                next_i += 1

        blocked = {"load_s": 0.0, "queue_forward_s": 0.0, "wait_forward_s": 0.0,
                   "write_flush_s": 0.0}
        batch_seconds = []
        pending = None  # (batch, scene idx, download, samples, n_real, clocks) awaiting download
        end_lock = threading.Lock()

        def _write_one(si, sample, maps):
            _write_sample_outputs(
                scene_meta[si]["out_folder"], sample, maps["depth"], maps["confidence"],
                maps["depth_sweep"], cfg.sample_scale, maps.get("depth_sweep_up"),
            )
            with end_lock:  # the writer threads share the scene's record
                scene_meta[si]["end"] = max(scene_meta[si]["end"], time.time())

        def _clock():
            """A point in time on the stream the forward runs on (an event), or on the host."""
            if not on_gpu:
                return time.perf_counter()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event

        def _drain(p):
            """Wait for a queued batch's download and hand its writes to the pool."""
            i, si, download, samples, n_real, (began, ended) = p
            with TRACER.span("eval.drain", into=blocked, key="wait_forward_s", request=i):
                maps = unpack_rows(finish_download(*download), names, shapes)[rows.start:]
                if on_gpu:
                    ended.synchronize()
                    batch_seconds.append(began.elapsed_time(ended) / 1e3)
                else:
                    batch_seconds.append(ended - began)
            meta = scene_meta[si]
            for b in range(n_real if writer else 0):
                meta["write_futures"].append(write_pool.submit(_write_one, si, samples[b], maps[b]))
            meta["done"] += n_real
            if meta["done"] % 10 < n_real or meta["done"] == meta["n"]:
                log.info(f"{meta['name']}: {meta['done']}/{meta['n']} drained")

        try:
            _top_up()
            for i in range(len(work)):
                waited_from = time.time()
                # the first batch's load is start-up, under its request
                with TRACER.span("eval.first_load" if i == 0 else "eval.load_wait",
                                 into=blocked, key="load_s", request=i if i else None):
                    si, fut = queue.popleft()
                    (host_images, host_cams), samples, n_real = fut.result()
                    _top_up()
                if scene_meta[si]["start"] is None:
                    scene_meta[si]["start"] = waited_from
                if i == 0:
                    startup.__exit__(None, None, None)  # start-up ends as the first forward goes
                with TRACER.span("eval.forward", into=blocked, key="queue_forward_s", request=i):
                    began = _clock()
                    download = packed_forward(model, cfg, host_images, host_cams, device,
                                              False, maps_of, mesh, out_prob_map=True,
                                              upsample=full_viz)
                    ended = _clock()
                if pending is not None:
                    _drain(pending)
                pending = (i, si, download, samples, n_real, (began, ended))
            if pending is not None:
                _drain(pending)
            with TRACER.span("eval.write_flush", into=blocked, key="write_flush_s"):
                for meta in scene_meta:
                    for f in meta["write_futures"]:
                        f.result()  # surface writer exceptions
                if mesh is not None:
                    dist.barrier()  # every rank's files are written

            scene_stats = {}
            for meta in scene_meta:
                if meta["start"] is None or (mesh is not None and dist.get_rank() != 0):
                    continue
                scene_runtime = max(meta["end"], meta["start"]) - meta["start"]
                with open(
                    os.path.join(savepath, meta["name"], "zz_runtime.txt"), "w"
                ) as f:
                    f.write("runtime " + str(scene_runtime))
                n = meta["n"]
                maps_per_s = n / max(scene_runtime, 1e-9)
                scene_stats[meta["name"]] = {"ref_images": n, "seconds": scene_runtime,
                                             "maps_per_s": maps_per_s}
                log.info(
                    f"{meta['name']}: {n} ref images in {scene_runtime:.1f}s wall "
                    f"({maps_per_s:.2f} maps/s)"
                )
            log.info(
                f"run blocked: load {blocked['load_s']:.1f}s, queueing forwards "
                f"{blocked['queue_forward_s']:.1f}s, waiting for forwards "
                f"{blocked['wait_forward_s']:.1f}s, write-flush {blocked['write_flush_s']:.1f}s"
            )
            if len(batch_seconds) > 1:
                # nothing is compiled, yet the first forward of a shape is slower than the
                # rest: the convolution library tries its algorithms and the allocator grows
                log.info(
                    f"  first batch {batch_seconds[0]:.2f}s (the convolution library's "
                    f"algorithm search and the allocator's growth), the others "
                    f"{float(np.median(batch_seconds[1:])):.2f}s (median)"
                )
            return {"blocked": blocked, "batch_seconds": batch_seconds, "scenes": scene_stats}
        finally:
            # after a fault, samples still queued are dropped, not decoded
            load_pool.shutdown(wait=False, cancel_futures=True)
            if sample_pool is not None:
                sample_pool.shutdown(wait=False, cancel_futures=True)
            write_pool.shutdown(wait=True)
    finally:
        startup.__exit__(None, None, None)  # a no-op once closed: open only if start-up raised


def _quant_mode(field: str):
    """An argparse type that refuses what PipelineConfig refuses, with its message (before
    argparse's list of choices)."""

    def parse(value: str) -> str:
        try:
            PipelineConfig(**{field: value})
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from None
        return value

    return parse


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", default="../data/")
    ap.add_argument("--savepath", default="./eval_out/")
    ap.add_argument("--scenes", nargs="*", default=ETH3D_SCENES)
    ap.add_argument("--view_num", type=int, default=8)
    ap.add_argument("--max_d", type=int, default=128)
    ap.add_argument("--max_w", type=int, default=896)
    ap.add_argument("--max_h", type=int, default=480)
    ap.add_argument("--params", default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--batch", type=int, default=1,
                    help="ref images per forward (pure data batching)")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. data=2,view=4, under torchrun (shards the batch over "
                         "'data' and view pairs over 'view')")
    ap.add_argument("--load_workers", type=int, default=6)
    ap.add_argument("--write_workers", type=int, default=2)
    ap.add_argument("--gt_range", action="store_true",
                    help="override sweep ranges from GT depth maps when present "
                         "(reference eval_pointcloud.py:171-193)")
    ap.add_argument("--full_viz", action="store_true",
                    help="render the viz PNG from the 4x-upsampled map like the "
                         "reference (costs the full upsampled soft-argmin chain; "
                         "the PFM outputs are identical either way)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (an error without CUDA)")
    ap.add_argument("--act-quant", default="none", type=_quant_mode("act_quant"),
                    choices=list(ACT_QUANT_MODES),
                    help="int8 storage of the volume links (PipelineConfig.act_quant; "
                         "inference only): int8 a per-tensor scale, int8s a static one, "
                         "int8mxu int8s plus the volume convs on int8 operands (a CUDA "
                         "kernel on the tensor cores). Default none = the exact path")
    ap.add_argument("--warp-quant", default="none", type=_quant_mode("warp_quant"),
                    choices=list(WARP_QUANT_MODES),
                    help="int8 storage for the warped feature volumes "
                         "(PipelineConfig.warp_quant; independent of --act-quant)")
    args = ap.parse_args()
    run_eval_pc(
        args.data_root, args.savepath, args.scenes,
        view_num=args.view_num, max_d=args.max_d, max_w=args.max_w, max_h=args.max_h,
        params_path=args.params, compute_dtype=args.dtype,
        batch=args.batch, mesh=args.mesh,
        load_workers=args.load_workers, write_workers=args.write_workers,
        gt_range=args.gt_range, full_viz=args.full_viz, device=args.device,
        act_quant=args.act_quant, warp_quant=args.warp_quant,
    )


if __name__ == "__main__":
    main()
