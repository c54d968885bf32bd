"""Multi-view 2D→3D feature lifting over a device mesh (the counterpart of
segsplat_tpu/parallel/lift.py).

  * the views split over the mesh's ``view`` ranks: each rank ray-marches its
    contiguous share of them (``ops/lift.first_hit_voxels``) against the
    whole occupancy grid and sums their features into a [num_ids, C] table in
    its own device memory (``scatter_features``, the same bits on every run);
  * the feature channels split over the ``tensor`` ranks: each sums only its
    C/n_tensor channels. Each tensor rank marches the rays again, so the
    tensor axis shrinks the accumulator and the feature reads, not the march;
  * one ``all_reduce`` over the view ranks merges the sums and the counts,
    and one ``all_gather`` over the tensor ranks joins the channel slices.

Unlike the JAX package, views are not padded to a multiple of the view axis:
a rank may get fewer views than another, or none. (A padded view of zero c2w
and intrinsics makes the JAX DDA hit voxel (0, 0, 0); ROADMAP Queue 3.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from segsplat_tpu_torch.ops.lift import first_hit_voxels, scatter_features
from segsplat_tpu_torch.parallel.mesh import (TENSOR_AXIS, VIEW_AXIS, Mesh, channel_shard,
                                              view_shard)


def lift_views_sharded(mesh: Mesh,
                       features_2d: torch.Tensor,   # [V, H, W, C]
                       occupancy: torch.Tensor,     # [Z, Y, X] int32
                       c2ws: torch.Tensor,          # [V, 4, 4]
                       intrinsics: torch.Tensor,    # [V, 4]
                       grid_origin: torch.Tensor, voxel_size: torch.Tensor,
                       depth_min: float, depth_max: float, ray_increment,
                       num_ids: int, max_steps: int,
                       chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-view feature lift on the occupancy's device, over ``mesh``. Every
    rank passes the whole view set; C must be a multiple of the tensor axis.
    Returns the full (sums [num_ids, C] f32, counts [num_ids] i32) on every
    rank."""
    V, H, W, C = features_2d.shape
    dev = occupancy.device
    inc = torch.as_tensor(ray_increment, dtype=torch.float32, device=dev)
    feats = channel_shard(view_shard(features_2d, mesh), mesh, axis=3)
    sums = torch.zeros((num_ids, feats.shape[-1]), dtype=torch.float32, device=dev)
    counts = torch.zeros((num_ids,), dtype=torch.int32, device=dev)
    for f, c2w, K in zip(feats, view_shard(c2ws, mesh), view_shard(intrinsics, mesh)):
        hits = first_hit_voxels(occupancy, c2w.to(dev), K.to(dev), grid_origin, voxel_size,
                                depth_min, depth_max, inc, W, H, max_steps, chunk)
        s, c = scatter_features(f.to(dev), hits, num_ids)
        sums, counts = sums + s, counts + c
    # the counts do not depend on the channels: summed over the view ranks only
    mesh.all_reduce(sums, VIEW_AXIS)
    mesh.all_reduce(counts, VIEW_AXIS)
    return mesh.all_gather(sums, TENSOR_AXIS, dim=1), counts
