"""The 'depth' mesh axis: this rank's block of the D sweep planes, and the three collectives
that a volume split along D needs (the port of what XLA's partitioner inserts for the JAX
package's `constrain_pairs` / `constrain_volume`, atvsnet_tpu/parallel/pipeline.py).

A rank of a depth group holds planes [offset, offset + D / n_depth) of every plane-sweep
volume (B, D, h, w, C) and of every cost (B, D, h, w), at every resolution of the U-Nets
(D / 2, D / 4 and D / 8 planes there, at offset / 2, ...). What crosses the seams:

  * halos: a 3x3x3 conv or transposed conv reads one boundary plane of a neighbour
    (`DepthSplit.halo`); zeros only at the global ends, as TF-SAME pads them;
  * per-sample statistics: batch_stat_norm's sums over (D, h, w), summed over the group
    before the normalize (`DepthSplit.all_sum`);
  * the soft-argmin's reduction over D: each rank's online-softmax triple, merged
    (ops.softargmin.merge_partials).

All three are all-reduces. gloo reduces CUDA tensors but gathers none, and an all-reduce
of zero-padded planes is exact (as parallel.mesh.gather_blocks), so the same code serves
NCCL and gloo, the latter for ranks that share one card. Those that carry a gradient go
through torch.distributed.nn's all-reduce, whose backward all-reduces the gradient: every
depth rank then differentiates the same replicated loss, and the world's gradient sum
counts it n_depth times (models.train divides).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from atvsnet_torch.parallel.mesh import Mesh, all_reduce_sum

# the U-Nets' three stride-2 levels halve every block of planes three times
UNET_LEVELS = 3


def check_depth_split(depth_num: int, n_depth: int) -> None:
    """D must cut into n_depth equal blocks that stay even through the U-Nets' levels."""
    if n_depth < 1 or depth_num % (2 ** UNET_LEVELS * n_depth):
        raise ValueError(
            f"max_d={depth_num} does not split over a 'depth' axis of {n_depth}: the "
            f"3-level U-Nets need max_d % (8 * n_depth) == 0")


@dataclasses.dataclass(frozen=True)
class DepthSplit:
    """This rank's block of the D planes: its depth group, its rank and the group's extent,
    and the global plane count D. offset and planes index the global D at full
    resolution; the halo and the sums work at any level of the U-Nets."""

    group: dist.ProcessGroup
    rank: int
    size: int
    depth_num: int

    def __post_init__(self):
        check_depth_split(self.depth_num, self.size)

    @classmethod
    def of(cls, mesh: Mesh | None, depth_num: int) -> "DepthSplit | None":
        """The split of a mesh with a 'depth' axis; None without one (or at extent 1)."""
        if mesh is None or mesh.depth_group is None:
            return None
        return cls(mesh.depth_group, mesh.depth_rank, mesh.n_depth, depth_num)

    @property
    def local(self) -> int:
        return self.depth_num // self.size

    @property
    def offset(self) -> int:
        return self.rank * self.local

    @property
    def planes(self) -> slice:
        """This rank's planes of a full-D axis."""
        return slice(self.offset, self.offset + self.local)

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    @property
    def is_last(self) -> bool:
        return self.rank == self.size - 1

    def halo(self, x: torch.Tensor, left: int, right: int, dim: int = 1) -> torch.Tensor:
        """x with its left neighbour's last plane before it (left=1) and its right
        neighbour's first plane after it (right=1) along `dim`; a zero plane where the
        neighbour would lie beyond a global end.

        One all-reduce of a buffer of size * (left + right) planes, rank r's halos at
        [r * k, (r + 1) * k): each rank writes its last plane into its right neighbour's
        left slot and its first plane into its left neighbour's right slot, the end ranks
        around the ring, and zeroes what came around the ring after the reduce. So every
        rank runs the same operations and reads its own slots of the result: the
        backward's collectives come in the same order on every rank (autograd orders its
        work by the graph, which a rank-dependent branch would change), and the
        all-reduce's backward hands each plane's gradient to its owner.
        """
        if left not in (0, 1) or right not in (0, 1):
            raise ValueError(f"halos are one plane wide, got left={left}, right={right}")
        k = left + right
        if not k:
            return x
        dtype = x.dtype
        xf = x.to(torch.float32)   # gloo reduces no bfloat16
        n = xf.shape[dim]
        slots = [torch.zeros_like(xf.narrow(dim, 0, 1))] * (self.size * k)
        if left:     # my last plane is my right neighbour's left halo
            slots[(self.rank + 1) % self.size * k] = xf.narrow(dim, n - 1, 1)
        if right:    # my first plane is my left neighbour's right halo
            slots[(self.rank - 1) % self.size * k + k - 1] = xf.narrow(dim, 0, 1)
        mine = all_reduce_sum(torch.cat(slots, dim), self.group).narrow(dim, self.rank * k, k)
        # beyond a global end the halo is zero, whatever came around the ring
        keep = torch.tensor(([not self.is_first] if left else []) + ([not self.is_last] if right else []),
                            device=x.device).view([k if d == dim else 1 for d in range(x.ndim)])
        mine = torch.where(keep, mine, torch.zeros((), device=x.device)).to(dtype)
        parts = ([mine.narrow(dim, 0, 1)] if left else []) + [x] + (
            [mine.narrow(dim, k - 1, 1)] if right else [])
        return torch.cat(parts, dim)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the depth group that autograd differentiates."""
        return all_reduce_sum(x, self.group)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the depth group, with no gradient (it only steadies an exponent or
        sets a scale)."""
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x
