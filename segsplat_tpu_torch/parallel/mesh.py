"""A (view, tensor) device mesh over ``torch.distributed`` (the counterpart of
segsplat_tpu/parallel/mesh.py).

One process drives one device. The world's ranks form an n_view × n_tensor
grid in row-major order, world rank = view_index·n_tensor + tensor_index (the
order of JAX's ``np.asarray(devices).reshape(n_view, n_tensor)``):

  * ``view``: data parallelism over cameras. Lifting splits the view sweep
    over the view ranks and sums the voxel accumulators over them; training
    splits the view batch and sums the gradients.
  * ``tensor``: the ranks of one view index split a wide axis: the lift's
    feature channels, the codebook's 256 logit rows in training.

Each axis has its own process group. Without a process group the mesh is
1×1 and its collectives are identities. The JAX package's ``NamedSharding``
helpers become plain tensor functions: ``view_shard`` takes this rank's slice
of a batch, ``channel_shard`` its slice of a channel axis, and ``replicate``
broadcasts tensors from world rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

VIEW_AXIS = "view"
TENSOR_AXIS = "tensor"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (view, tensor) grid and each axis's process
    group (None: no process group, a 1×1 mesh)."""

    n_view: int
    n_tensor: int
    view_index: int
    tensor_index: int
    groups: Optional[dict] = None   # {VIEW_AXIS: group, TENSOR_AXIS: group}

    @property
    def shape(self) -> dict:
        return {VIEW_AXIS: self.n_view, TENSOR_AXIS: self.n_tensor}

    @property
    def size(self) -> int:
        return self.n_view * self.n_tensor

    @property
    def is_rank0(self) -> bool:
        return self.view_index == 0 and self.tensor_index == 0

    def all_reduce(self, x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over ``axis``'s ranks, in place."""
        if self.groups is not None:
            dist.all_reduce(x, op=op, group=self.groups[axis])
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ``axis`` ranks' ``x`` concatenated along ``dim`` in rank order."""
        if self.groups is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=self.groups[axis])
        return torch.cat(parts, dim=dim)


def make_mesh(n_view: Optional[int] = None, n_tensor: int = 1) -> Mesh:
    """A (view, tensor) mesh over the default process group, all its ranks on
    the view axis unless ``n_view`` is given. Every rank must call it, in the
    same order as its other process-group calls. Without a process group only
    the 1×1 mesh exists; a mesh that does not cover the world raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_view is None:
        n_view = max(world // n_tensor, 1)
    if n_view < 1 or n_tensor < 1 or n_view * n_tensor != world:
        where = "process group" if dist.is_initialized() else "process (no process group)"
        raise ValueError(f"mesh view={n_view} x tensor={n_tensor} needs {n_view * n_tensor} "
                         f"ranks, but the {where} has {world}")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, None)
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order; it keeps the two it is in
    for t in range(n_tensor):
        g = dist.new_group([v * n_tensor + t for v in range(n_view)])
        if rank % n_tensor == t:
            groups[VIEW_AXIS] = g
    for v in range(n_view):
        g = dist.new_group([v * n_tensor + t for t in range(n_tensor)])
        if rank // n_tensor == v:
            groups[TENSOR_AXIS] = g
    return Mesh(n_view, n_tensor, rank // n_tensor, rank % n_tensor, groups)


def shard_range(n: int, parts: int, index: int) -> tuple:
    """[start, stop) of part ``index`` when ``n`` items split into ``parts``
    contiguous parts, the first n % parts of them one longer (numpy's
    ``array_split``); a part may be empty."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return start, start + base + (index < extra)


def view_shard(x, mesh: Mesh):
    """This rank's contiguous slice of the leading axis of ``x`` (a tensor or
    a list) over the view axis."""
    start, stop = shard_range(len(x), mesh.n_view, mesh.view_index)
    return x[start:stop]


def channel_shard(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """This rank's slice of ``axis`` over the tensor axis; the axis must
    divide evenly."""
    n = x.shape[axis]
    if n % mesh.n_tensor:
        raise ValueError(f"axis {axis} of size {n} does not split over tensor={mesh.n_tensor}")
    width = n // mesh.n_tensor
    return x.narrow(axis, mesh.tensor_index * width, width)


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> Sequence[torch.Tensor]:
    """Broadcast each tensor from world rank 0 to every rank, in place."""
    if mesh.groups is not None:
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tensors
