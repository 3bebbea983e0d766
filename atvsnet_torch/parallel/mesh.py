"""The device mesh over torch.distributed (atvsnet_tpu/parallel/mesh.py).

One process per device, as torchrun starts them. The mesh has two axes, or three:

  'data'  scenes / reference images: each data rank runs its own rows of the batch.
  'view'  the N-1 view pairs of stages 1 and 3: each view rank runs a contiguous block
          of them. They meet only inside the attention aggregation, whose cross-view
          terms become all-reduces over the view group (nn.aam).
  'depth' (n_depth > 1 only) the D sweep planes of every volume: each depth rank holds a
          contiguous block of them, with halo exchanges, summed statistics and a merged
          soft-argmin across the seams (parallel.depth). An HBM alternative to remat.

Ranks are laid out row-major over (data, view[, depth]), as the JAX package reshapes its
devices: rank = (data_rank * n_view + view_rank) * n_depth + depth_rank, so the ranks of
one depth group are neighbours and those of one data group share its rows.

The backend follows the device: NCCL for CUDA, gloo for the CPU. A CUDA mesh whose
process group cannot start raises; nothing falls back to another backend or device.
A caller that has started the default process group itself (gloo over CUDA tensors, for
several ranks sharing one card) keeps it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from atvsnet_torch import resolve_device

AXES = ("data", "view")
AXES_DEPTH = AXES + ("depth",)


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """'data=2,view=4' -> (2, 4); missing axes default to 1."""
    axes = {"data": 1, "view": 1}
    for part in spec.split(","):
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in axes:
            raise ValueError(f"unknown mesh axis {name!r} (want data/view)")
        axes[name] = int(val)
    return axes["data"], axes["view"]


def auto_mesh_shape(n_devices: int, num_pairs: int) -> tuple[int, int]:
    """(n_data, n_view): the largest divisor of num_pairs that divides n_devices goes to
    'view'; the rest becomes data parallelism."""
    n_view = 1
    for cand in range(min(n_devices, num_pairs), 0, -1):
        if num_pairs % cand == 0 and n_devices % cand == 0:
            n_view = cand
            break
    return n_devices // n_view, n_view


def block(n: int, parts: int, index: int) -> slice:
    """Block `index` of `n` items cut into `parts` equal contiguous blocks."""
    if n % parts:
        raise ValueError(f"{n} items do not split into {parts} equal blocks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, view[, depth]) mesh, its device and its groups."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def n_data(self) -> int:
        return self.device_mesh.size(0)

    @property
    def n_view(self) -> int:
        return self.device_mesh.size(1)

    @property
    def data_rank(self) -> int:
        return self.device_mesh.get_local_rank("data")

    @property
    def view_rank(self) -> int:
        return self.device_mesh.get_local_rank("view")

    @property
    def n_depth(self) -> int:
        return self.device_mesh.size(2) if self.device_mesh.ndim == 3 else 1

    @property
    def depth_rank(self) -> int:
        return self.device_mesh.get_local_rank("depth") if self.device_mesh.ndim == 3 else 0

    @property
    def depth_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks that hold the other planes of these rows and pairs (None when 'depth'
        has extent 1)."""
        return self.device_mesh.get_group("depth") if self.n_depth > 1 else None

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks that hold the other rows (None when 'data' has extent 1)."""
        return self.device_mesh.get_group("data") if self.n_data > 1 else None

    @property
    def view_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks that hold the other pairs of these rows (None when 'view' has extent 1)."""
        return self.device_mesh.get_group("view") if self.n_view > 1 else None

    def data_rows(self, x):
        """This rank's rows of a batch-leading array or tensor (the layout of P('data'))."""
        return x[block(len(x), self.n_data, self.data_rank)]

    def pair_block(self, num_pairs: int) -> range:
        """This rank's pairs (the layout of P('view')): pair p is view p + 1."""
        s = block(num_pairs, self.n_view, self.view_rank)
        return range(s.start, s.stop)

    def plane_block(self, depth_num: int) -> slice:
        """This rank's planes of a D axis (the layout of P(..., 'depth'))."""
        return block(depth_num, self.n_depth, self.depth_rank)

    def forward_layout(self, num_pairs: int, depth_num: int) -> dict:
        """This rank's share of the N-view forward, as models.atvsnet.forward_stages takes
        it: its pairs, the view group that AAM reduces over and its depth split."""
        from atvsnet_torch.parallel.depth import DepthSplit   # depth builds on this module

        return {"pairs": self.pair_block(num_pairs), "group": self.view_group,
                "split": DepthSplit.of(self, depth_num)}


def make_mesh(n_data: int = 1, n_view: int = 1, n_depth: int = 1, device=None) -> Mesh:
    """The ('data', 'view') mesh of this process, or ('data', 'view', 'depth') when
    n_depth > 1, on `device` (CUDA when None).

    Starts the default process group (from torchrun's environment) unless the caller
    has; its world must hold exactly n_data * n_view * n_depth ranks. A CUDA device
    without an index becomes cuda:(LOCAL_RANK, else the rank, modulo the card count).
    Whether D splits over n_depth is checked where D is known (parallel.depth).
    """
    if min(n_data, n_view, n_depth) < 1:
        raise ValueError(f"mesh extents must be positive, got ({n_data}, {n_view}, {n_depth})")
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                      else os.environ.get("RANK", 0)))
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    shape = (n_data, n_view) if n_depth == 1 else (n_data, n_view, n_depth)
    need, have = n_data * n_view * n_depth, dist.get_world_size()
    if have != need:
        raise ValueError(f"a {shape} mesh needs {need} processes, the world has {have}")
    names = AXES if n_depth == 1 else AXES_DEPTH
    return Mesh(init_device_mesh(device.type, shape, mesh_dim_names=names), device)


def gather_blocks(x: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's block of `group` along `dim`, in rank order, on every rank.

    An all-reduce of zero-padded blocks, and not an all_gather: gloo gathers no CUDA
    tensors, and the all-reduce takes both backends the same way. Adding zeros is exact.
    Autograd sees it: each rank's block gets the gradient summed over the ranks.
    """
    if group is None:
        return x
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    dtype = x.dtype
    x = x.to(torch.float32)   # gloo reduces no bfloat16
    parts = [x if r == rank else torch.zeros_like(x) for r in range(size)]
    return dist_nn.all_reduce(torch.cat(parts, dim=dim), group=group).to(dtype)


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum over `group` that autograd differentiates (identity without a group)."""
    return x if group is None else dist_nn.all_reduce(x, group=group)
