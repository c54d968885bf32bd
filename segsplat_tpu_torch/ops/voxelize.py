"""Sparse voxel quantization (the counterpart of segsplat_tpu/ops/voxelize.py).

The reference quantizes points two ways:
  * floor-quantization for grid *construction*: ``floor((p - min) / cell)``
    then unique, centres at ``idx * cell + min``
    (minkowski_voxel_grid_from_ply_advanced.py:136-151),
  * round-quantization for *occupancy lookup*: ``round((p - origin) / vs)``
    with 1-based voxel ids in input order in a dense [Z, Y, X] int array
    (cuda_project_image_to_sparse_voxel/build_sparse_occupancy.py:32-53).

Grid construction is host numpy, as in the JAX package. The per-voxel
reductions replace the reference's CUDA atomics with reductions whose result
does not depend on the order threads finish in (``segment_sum``): float rows
are sorted stably by voxel id and each voxel's rows summed in input order by
``torch.segment_reduce``, on the CPU and on the card alike, where
``index_put_``/``index_add_`` would accumulate in an order that varies between
runs (on the CPU too, for ``index_put_``); integer sums and maxima
(``scatter_reduce_`` with ``amax``) are the same in any order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from segsplat_tpu_torch.core.types import VoxelGrid

INT32_MIN = torch.iinfo(torch.int32).min


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments, ...] sums of ``values`` rows by ``ids`` (all in range):
    each segment's rows added in input order, as JAX's segment_sum adds them on
    the CPU, with the same bits on every run (see the module docstring)."""
    ids = ids.long()
    if not values.dtype.is_floating_point:
        out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                          device=values.device)
        return out.index_put_((ids,), values, accumulate=True)
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=num_segments)
    return torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0, unsafe=True)


def pack_coords(coords: torch.Tensor, shape_xyz) -> torch.Tensor:
    """[V, 3] int (x, y, z) → int32 linear key z·Y·X + y·X + x (the dense
    occupancy layout, build_sparse_occupancy.py:44-46). The keys stay int32 as
    in the JAX package, so a grid of 2³¹ cells or more raises."""
    X, Y = int(shape_xyz[0]), int(shape_xyz[1])
    Z = int(shape_xyz[2]) if len(shape_xyz) > 2 else 1
    if Z * Y * X >= 2 ** 31:
        raise ValueError(
            f"grid {X}x{Y}x{Z} has {Z * Y * X} cells >= 2^31: linear keys "
            f"would overflow int32 — raise voxel_size or shrink the grid")
    c = coords.to(torch.int32)
    return c[:, 2] * (Y * X) + c[:, 1] * X + c[:, 0]


def unpack_key(key: torch.Tensor, shape_xyz) -> torch.Tensor:
    X, Y = int(shape_xyz[0]), int(shape_xyz[1])
    z = torch.div(key, Y * X, rounding_mode="floor")
    rem = key - z * (Y * X)
    y = torch.div(rem, X, rounding_mode="floor")
    x = rem - y * X
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def voxelize_points(points: np.ndarray, voxel_size: float,
                    features: Optional[np.ndarray] = None,
                    origin: Optional[np.ndarray] = None,
                    reduction: str = "mean",
                    device: str | torch.device = "cuda") -> VoxelGrid:
    """Floor-quantize points into a sparse grid, with an optional per-voxel
    mean (or sum) of ``features``; host numpy, the result on ``device``. The
    origin defaults to the min corner and centres are coord·vs + origin (the
    reference's "centre" is the cell's low corner; kept for format parity)."""
    points = np.asarray(points, np.float64)
    if origin is None:
        origin = points.min(axis=0)
    idx = np.floor((points - origin) / voxel_size).astype(np.int64)
    uniq, inverse = np.unique(idx, axis=0, return_inverse=True)
    feats = None
    if features is not None:
        features = np.asarray(features)
        # float64 sums and counts whatever the input dtype, cast back once
        counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
        feats = np.zeros((len(uniq),) + features.shape[1:], np.float64)
        np.add.at(feats, inverse, features.astype(np.float64))
        if reduction == "mean":
            feats = feats / np.maximum(counts, 1)[:, None]
        feats = feats.astype(features.dtype)
    shape_zyx = (tuple(int(s) for s in (uniq.max(axis=0) + 1)[::-1]) if len(uniq)
                 else (0, 0, 0))
    return VoxelGrid(
        coords=torch.as_tensor(uniq.astype(np.int32), device=device),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=device),
        features=None if feats is None else torch.as_tensor(feats, device=device),
        shape=shape_zyx,
    )


def occupancy_from_grid(grid: VoxelGrid, round_centers: bool = True
                        ) -> Tuple[torch.Tensor, np.ndarray, tuple]:
    """Dense [Z, Y, X] int32 occupancy with 1-based voxel ids on the grid's
    device, from the grid's centres re-quantized by round() against its origin,
    as build_sparse_occupancy.py:32-53 does (negative indices shift the origin).
    Voxel id i+1 is ``grid.coords[i]`` (input order). Returns (occupancy,
    origin [3] f32, shape (Z, Y, X))."""
    centers = grid.centers().cpu().numpy().astype(np.float64)
    origin = grid.origin.cpu().numpy().astype(np.float64)
    vs = float(grid.voxel_size)
    if round_centers:
        idx = np.round((centers - origin) / vs).astype(np.int64)
    else:
        idx = grid.coords.cpu().numpy().astype(np.int64)
    if (idx < 0).any():
        shift = np.minimum(idx.min(axis=0), 0)
        idx = idx - shift
        origin = origin + shift * vs
    shape = tuple(int(s) for s in (idx.max(axis=0) + 1)[::-1])     # (Z, Y, X)
    occ = np.zeros(shape, np.int32)
    occ[idx[:, 2], idx[:, 1], idx[:, 0]] = np.arange(1, len(idx) + 1, dtype=np.int32)
    return torch.as_tensor(occ, device=grid.coords.device), origin.astype(np.float32), shape


def reduce_by_voxel(values: torch.Tensor, voxel_ids: torch.Tensor, num_voxels: int,
                    reduction: str = "sum") -> torch.Tensor:
    """Per-voxel ``sum`` or ``max`` of ``values`` [N, F] by ``voxel_ids`` [N]
    in [0, num_voxels); negative ids go to a trash row that is dropped."""
    valid = voxel_ids >= 0
    ids = torch.where(valid, voxel_ids, num_voxels).long()
    if reduction == "sum":
        out = segment_sum(torch.where(valid[:, None], values, 0), ids, num_voxels + 1)
    elif reduction == "max":
        # dropped rows and empty voxels hold the identity of max, as JAX's
        # segment_max leaves them
        ident = -torch.inf if values.dtype.is_floating_point else INT32_MIN
        vals = torch.where(valid[:, None], values, ident)
        out = torch.full((num_voxels + 1,) + values.shape[1:], ident, dtype=values.dtype,
                         device=values.device)
        out.scatter_reduce_(0, ids[:, None].expand_as(vals), vals, reduce="amax")
    else:
        raise ValueError(reduction)
    return out[:num_voxels]


def count_by_voxel(voxel_ids: torch.Tensor, num_voxels: int) -> torch.Tensor:
    valid = voxel_ids >= 0
    ids = torch.where(valid, voxel_ids, num_voxels).long()
    return torch.bincount(ids, minlength=num_voxels + 1)[:num_voxels].to(torch.int32)


def unique_voxels_jit(coords: torch.Tensor, capacity: int, shape_xyz):
    """Unique of quantized coords by sorted keys, with JAX's outputs: (unique
    keys [capacity] int32 padded with -1, inverse [N] int32, num_unique [] int32).
    The name is kept from the JAX package, whose version runs inside jit."""
    keys = pack_coords(coords, shape_xyz)
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    is_new = torch.cat([torch.ones((1,), dtype=torch.bool, device=keys.device),
                        sk[1:] != sk[:-1]])
    uidx = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = uidx[-1] + 1
    uniq = torch.full((capacity + 1,), -1, dtype=torch.int32, device=keys.device)
    # repeats, and uniques past ``capacity``, land in a trash row
    uniq[torch.where(is_new & (uidx < capacity), uidx, capacity).long()] = sk
    uniq = uniq[:capacity]
    inverse = torch.zeros_like(uidx)
    inverse[order] = uidx
    return uniq, inverse, num_unique
