"""In-process serving API: load weights once, serve depth maps from one resident model
(the port of atvsnet_tpu/serving.py).

A `DepthEstimator` holds one device-resident ATVSNet and a registry of shape buckets.
Every request is routed to the best-fitting bucket, prepared on the host by the eval
script's policy (data.preprocess.prepare_mvs_sample: scale, pad, crop, inverse-depth
sweep) and run through the eager forward under torch.no_grad(). Feed scenes as
in-memory arrays or file paths, get metric depth and confidence back, already un-padded.

    est = DepthEstimator(PipelineConfig(view_num=5), params_path="model.npz")
    est.add_bucket(max_h=256, max_w=320)  # optional second resolution bucket
    out = est.predict(images, cams)       # lists of np arrays / (2,4,4) cams
    out["depth"]                          # (H/4, W/4) metric depth
    out["depth_up"], out["confidence"]    # 4x-upsampled depth, confidence map

Transfers: raw uint8 frames go up as uint8 (a quarter of the fp32 bytes) and are
variance-normalized on the device; the 2-4 output maps come down as ONE packed fp32 row
per sample, one device-to-host copy into pinned memory, sliced back on the host.

predict() serves one sample per call; predict_many() batches several requests through
one forward. Normalization statistics are per sample, so a batched result is the
single-request result up to the convolution library's choice of algorithm per batch size.

The network is fully convolutional (no shape-dependent weights), so all buckets share the
one model. It runs on CUDA unless the caller passes device="cpu".

With a mesh (parallel.mesh: a spec such as "data=2,view=2", or a built Mesh) every rank of
the mesh holds the model and calls predict / predict_many with the same requests; the
batch is split over 'data' and the view pairs over 'view' (parallel.pipeline), and every
rank returns the same results.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from atvsnet_torch import resolve_device
from atvsnet_torch.config import PipelineConfig
from atvsnet_torch.data.cams import load_cam
from atvsnet_torch.data.image_io import imread
from atvsnet_torch.data.preprocess import prepare_mvs_sample
from atvsnet_torch.models.atvsnet import center_images, multi_view_forward, sweep_to_depth
from atvsnet_torch.models.tvsnet import two_view_forward
from atvsnet_torch.params import init_model, load_model
from atvsnet_torch.parallel.mesh import Mesh, gather_blocks, make_mesh, parse_mesh_spec
from atvsnet_torch.parallel.pipeline import forward_rows
from atvsnet_torch.utils.profiling import TRACER
from atvsnet_torch.utils.transfer import finish_download, start_download

# a bucket may override anything but the widths the shared model was built with
_WIDTH_FIELDS = ("fem_base_filter", "crm_base_filter", "shallow_base_filter", "refine_base_filter")


@torch.no_grad()
def packed_forward(model, c: PipelineConfig, images: np.ndarray, cams: np.ndarray, device,
                   centered: bool, maps_of, mesh: Optional[Mesh] = None, **forward_kw):
    """Upload, normalize on the device (unless `centered`), forward, and start the download
    of ONE flat fp32 row per sample that holds the maps `maps_of(out)` picks, one after the
    other. DepthEstimator and cli.eval_pointcloud both run their forwards through here.

    images (B, N, H, W, 3) of the bucket's size, uint8 or float; cams (B, N, 2, 4, 4);
    forward_kw goes to multi_view_forward (two_view_forward takes none). Returns
    utils.transfer.start_download's (host tensor (B, n), event): the caller waits with
    finish_download, at once or after it has queued more work.

    With a mesh, images and cams are this rank's rows of the batch (mesh.data_rows), the
    N-view forward is parallel.pipeline's and the two-view forward runs the rows alone;
    the rows of every data rank come down, in batch order, on every rank.

    Traced (utils.profiling.TRACER) as forward.upload (the upload and the centring) and
    forward.pack (the maps' packing and the download's start) around the forward.
    """
    with TRACER.span("forward.upload"):
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        x = x.to(torch.float32) if centered else center_images(x)
    if c.view_num == 2:
        out = two_view_forward(model, x, cams, c)
    elif mesh is None:
        out = multi_view_forward(model, x, cams, c, **forward_kw)
    else:
        out = forward_rows(model, x, cams, c, mesh, **forward_kw)
    with TRACER.span("forward.pack"):
        parts = maps_of(out)
        b = parts[0].shape[0]
        packed = torch.cat([p.to(torch.float32).reshape(b, -1) for p in parts], dim=1)
        return start_download(packed if mesh is None else gather_blocks(packed, mesh.data_group))


def unpack_rows(packed: np.ndarray, names, shapes) -> list[dict]:
    """Host side of packed_forward: slice the (B, n) rows back into named (rows, cols) maps."""
    results = []
    for row in packed:
        off, maps = 0, {}
        for name, shape in zip(names, shapes):
            size = shape[0] * shape[1]
            maps[name] = row[off:off + size].reshape(shape)
            off += size
        results.append(maps)
    return results


class DepthEstimator:
    """Persistent multi-view depth inference object.

    The same pipeline as the eval script's per-image inference (reference
    eval_pointcloud.py:212-397), packaged for reuse: parameters live on the device,
    requests are routed to the smallest registered shape bucket that fits (padding up
    when possible).
    """

    def __init__(
        self,
        cfg: Optional[PipelineConfig] = None,
        params: Optional[Mapping] = None,
        params_path: Optional[str] = None,
        seed: int = 0,
        with_confidence: bool = True,
        device=None,
        mesh: Union[str, Mesh, None] = None,
    ):
        """params: a JAX-layout parameter tree (nested or flat '/'-keyed); params_path: the
        .npz of such a tree; neither: random weights from `seed`. device: CUDA when None.
        mesh: a spec ("data=2,view=4") built with parallel.mesh.make_mesh on `device`, or a
        built Mesh, whose device the model then lives on."""
        self.cfg = cfg or PipelineConfig()
        self.with_confidence = with_confidence and self.cfg.view_num > 2
        if isinstance(mesh, str):
            mesh = make_mesh(*parse_mesh_spec(mesh), device=device)
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        if params is not None:
            self.model = load_model(params, self.cfg, self.device)
        elif params_path:
            self.model = load_model(params_path, self.cfg, self.device)
        else:
            self.model = init_model(self.cfg, seed, self.device)
        self._buckets: list[PipelineConfig] = []
        self.add_bucket()  # base bucket from self.cfg

    # ---- bucket registry -------------------------------------------------

    def add_bucket(self, **overrides) -> PipelineConfig:
        """Register a shape bucket: cfg.replace(**overrides). Returns the bucket's config;
        registering an existing bucket again changes nothing."""
        c = self.cfg.replace(**overrides) if overrides else self.cfg
        changed = [f for f in _WIDTH_FIELDS if getattr(c, f) != getattr(self.cfg, f)]
        if changed:
            raise ValueError(f"a bucket shares the estimator's model and cannot change {changed}")
        # a bucket IS its frozen config: every field tells two buckets apart, so one that
        # differs only in, say, inverse_depth or softargmin_impl is never served as another
        if c not in self._buckets:
            self._buckets.append(c)
        return c

    @property
    def buckets(self) -> list[PipelineConfig]:
        return list(self._buckets)

    def _route(self, h: int, w: int) -> PipelineConfig:
        """Smallest registered bucket that fits (pad up); else the largest bucket
        (prepare_mvs_sample downscales into it)."""
        fitting = [c for c in self.buckets if c.max_h >= h and c.max_w >= w]
        if fitting:
            return min(fitting, key=lambda c: c.max_h * c.max_w)
        return max(self.buckets, key=lambda c: c.max_h * c.max_w)

    # ---- the per-bucket program -------------------------------------------

    def _map_layout(self, c: PipelineConfig):
        """Names and (rows, cols) of the maps in one packed row, in order."""
        H, W = c.max_h, c.max_w
        h, w = int(H * c.sample_scale), int(W * c.sample_scale)
        with_conf = self.with_confidence and c.view_num > 2
        names = ["depth", "depth_up"] + (["confidence", "confidence_up"] if with_conf else [])
        return names, [(h, w), (H, W)] * (2 if with_conf else 1)

    @torch.no_grad()
    def _forward(self, c: PipelineConfig, images: np.ndarray, cams: np.ndarray,
                 centered: bool) -> tuple[list[dict], float]:
        """Upload, normalize on the device (unless `centered`), forward, metric conversion,
        and ONE flat fp32 row per sample brought down with one copy into pinned memory.

        images (B, N, H, W, 3) of the bucket's size, uint8 or float; cams (B, N, 2, 4, 4);
        with a mesh, B is a multiple of the 'data' extent and each rank runs its rows.
        Returns the per-sample maps (numpy views into the downloaded row) and the seconds
        from before the upload until the download has finished (the spans serve.forward and
        serve.download).
        """
        with_conf = self.with_confidence and c.view_num > 2

        def maps_of(out):
            parts = [sweep_to_depth(out["depth"], c.inverse_depth),
                     sweep_to_depth(out["depth_up"], c.inverse_depth)]
            return parts + ([out["confidence"], out["confidence_up"]] if with_conf else [])

        if self.mesh is not None:
            images, cams = self.mesh.data_rows(images), self.mesh.data_rows(cams)
        clock = {"runtime_s": 0.0}
        with TRACER.span("serve.forward", into=clock, key="runtime_s"):
            download = packed_forward(self.model, c, images, cams, self.device, centered,
                                      maps_of, self.mesh, out_prob_map=with_conf)
        with TRACER.span("serve.download", into=clock, key="runtime_s"):
            packed = finish_download(*download)
        with TRACER.span("serve.unpack"):
            maps = unpack_rows(packed, *self._map_layout(c))
        return maps, clock["runtime_s"]

    @staticmethod
    def _result(c: PipelineConfig, maps: dict, valid_hw, runtime: float) -> dict:
        """Crop one sample's maps back to the valid (un-padded) region."""
        vh, vw = valid_hw
        s = c.sample_scale
        res = {
            "depth": maps["depth"][: int(vh * s), : int(vw * s)],
            "depth_up": maps["depth_up"][:vh, :vw],
            "runtime_s": runtime,
            "bucket": (c.max_h, c.max_w),
        }
        if "confidence" in maps:
            res["confidence"] = maps["confidence"][: int(vh * s), : int(vw * s)]
            res["confidence_up"] = maps["confidence_up"][:vh, :vw]
        return res

    def _prepare(self, c: PipelineConfig, images, cams) -> dict:
        # center=False: the raw (typically uint8) stack goes up as it is and is
        # normalized on the device
        return prepare_mvs_sample(
            list(images), list(cams), c.view_num, max_d=c.max_d, max_h=c.max_h,
            max_w=c.max_w, sample_scale=c.sample_scale, inverse_depth=c.inverse_depth,
            center=False,
        )

    def _data_extent(self) -> int:
        """Size of the mesh's 'data' axis (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.n_data

    def _tile(self, x: np.ndarray) -> np.ndarray:
        """A one-sample batch repeated to the 'data' extent, so that every data rank has a
        row; sample 0 is read back."""
        nd = self._data_extent()
        return x if nd == 1 else np.concatenate([x] * nd, axis=0)

    # ---- inference -------------------------------------------------------

    def warmup(self, all_buckets: bool = False, include_pre: bool = False) -> float:
        """Run the deployment (raw uint8 input) path once on synthetic inputs, for the base
        bucket or all of them; returns seconds. The first forward of a shape pays the
        kernel build (once per process), cuDNN's algorithm choice and the allocator's
        growth. include_pre=True also runs the preprocessed=True path."""
        t0 = time.perf_counter()
        for c in self.buckets:
            rng = np.random.RandomState(0)
            images = rng.randint(0, 255, size=(1, c.view_num, c.max_h, c.max_w, 3)).astype(np.uint8)
            cam = np.zeros((2, 4, 4), np.float32)
            cam[0] = np.eye(4)
            cam[1, :3, :3] = np.array(
                [[c.max_w, 0, c.max_w / 2], [0, c.max_w, c.max_h / 2], [0, 0, 1]]
            )
            cam[1, 3] = (0.4, 0.6 / c.max_d, c.max_d, 1.0)
            cams = np.broadcast_to(cam, (1, c.view_num, 2, 4, 4)).copy()
            images, cams = self._tile(images), self._tile(cams)
            self._forward(c, images, cams, centered=False)
            if include_pre:
                self._forward(c, images.astype(np.float32), cams, centered=True)
            if not all_buckets:
                break
        return time.perf_counter() - t0

    def predict(
        self,
        images: Sequence[np.ndarray],
        cams: Sequence[np.ndarray],
        preprocessed: bool = False,
    ) -> dict:
        """[ref, view...] images (H, W, 3) + MVSNet-convention cams (2, 4, 4) -> depths.

        Fewer than the bucket's view_num views are padded with the reference (the
        reference script's fallback, eval_pointcloud.py:115-121); extra views are
        truncated. The request is routed to the smallest registered bucket that fits
        the input resolution. Returns numpy arrays cropped to the valid (un-padded)
        region:
          depth          (h, w)   metric depth at cost-volume resolution
          depth_up       (H, W)   metric depth at input resolution (4x)
          confidence(_up)         probability maps (multi-view only)
          runtime_s               seconds of upload + forward + download for this call
          bucket         (max_h, max_w) of the bucket that served the request
        preprocessed=True: the images are already normalized and of a bucket's exact
        size, and the cams already carry cost-volume intrinsics and the sweep row.
        With a mesh, every rank calls it with the same request and gets the result.
        Traced (utils.profiling.TRACER) as serve.request, with serve.prepare, serve.forward,
        serve.download and serve.unpack under one request id.
        """
        with TRACER.span("serve.request"):
            with TRACER.span("serve.prepare"):
                c, batch = self._prepare_request(images, cams, preprocessed)
            maps, runtime = self._forward(c, self._tile(batch["images"]),
                                          self._tile(batch["cams"]), centered=preprocessed)
            return self._result(c, maps[0], batch["valid_hw"], runtime)

    def _prepare_request(self, images, cams, preprocessed: bool):
        """predict's routing and preparation: (bucket, batch of one sample)."""
        h, w = images[0].shape[:2]
        c = self._route(h, w)
        if preprocessed:
            # preprocessed inputs must match a bucket exactly: sizes that are not
            # multiples of 32 fail deep inside the U-Nets
            if not any(b.max_h == h and b.max_w == w for b in self.buckets):
                raise ValueError(
                    f"preprocessed input is {h}x{w}, but the registered buckets are "
                    f"{[(b.max_h, b.max_w) for b in self.buckets]}; add_bucket"
                    f"(max_h={h}, max_w={w}) first, or use preprocessed=False"
                )
            images = list(images)[: c.view_num]
            cams = [np.copy(cm) for cm in cams[: c.view_num]]
            for v, im in enumerate(images):
                if im.shape[:2] != (c.max_h, c.max_w):
                    raise ValueError(
                        f"preprocessed view {v} has shape {im.shape[:2]}, expected "
                        f"({c.max_h}, {c.max_w}): all views must match the bucket"
                    )
            # view padding applies to this path too (preprocessed inputs skip only the
            # scaling, cropping and normalization, not the view-count contract)
            while len(images) < c.view_num:
                images.append(images[0])
                cams.append(np.copy(cams[0]))
            batch = {
                "images": np.stack(images)[None].astype(np.float32),
                "cams": np.stack(cams)[None].astype(np.float32),
                "valid_hw": (h, w),
            }
        else:
            batch = self._prepare(c, images, cams)
        return c, batch

    def predict_many(
        self,
        requests: Sequence[tuple[Sequence[np.ndarray], Sequence[np.ndarray]]],
    ) -> list[dict]:
        """Serve several (images, cams) requests through ONE batched forward.

        All requests route to a single bucket (the smallest fitting the largest
        request). Each request may have its own resolution and view count (per-sample
        preparation pads exactly like predict). Returns one predict()-shaped dict per
        request; runtime_s on each is the whole batch's time. With a mesh, every rank calls
        it with the same requests and gets every result: the batch is padded to a multiple
        of the 'data' extent by repeating the last request and split over 'data'.
        """
        if not requests:
            return []
        with TRACER.span("serve.request"):
            with TRACER.span("serve.prepare"):
                h = max(imgs[0].shape[0] for imgs, _ in requests)
                w = max(imgs[0].shape[1] for imgs, _ in requests)
                c = self._route(h, w)
                prepared = [self._prepare(c, imgs, cms) for imgs, cms in requests]
                padded = prepared + prepared[-1:] * (-len(prepared) % self._data_extent())
                images = np.concatenate([b["images"] for b in padded], axis=0)
                cams = np.concatenate([b["cams"] for b in padded], axis=0)
            all_maps, runtime = self._forward(c, images, cams, centered=False)
            return [self._result(c, maps, b["valid_hw"], runtime)
                    for maps, b in zip(all_maps, prepared)]

    def predict_paths(self, paths: Sequence[str]) -> dict:
        """Alternating [img, cam.txt, img, cam.txt, ...] file paths -> predict()."""
        n = len(paths) // 2
        images = [imread(paths[2 * v]) for v in range(n)]
        cams = [load_cam(paths[2 * v + 1], max_d=self.cfg.max_d) for v in range(n)]
        return self.predict(images, cams)
