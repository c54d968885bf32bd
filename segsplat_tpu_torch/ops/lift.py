"""2D→3D feature lifting: per-pixel ray march to the first occupied voxel (the
counterpart of segsplat_tpu/ops/lift.py, a transcription of the reference's
CUDA kernel cuda_project_image_to_sparse_voxel/project_image_cuda_kernel.cu:24-137).

Reference semantics, reproduced exactly:
  * camera ray through pixel (x, y): normalize(((x-cx)/fx, (y-cy)/fy, 1))
    (kinectProjToCamera, include/cudaUtil.h:104-119),
  * ray length t ∈ [depth_min, depth_max] · (1/camDir.z), stepped by
    ``ray_increment`` (kernel :31-47),
  * voxel snap round((world - grid_origin) / voxel_size) (kernel :50-51),
  * the first occupied voxel along the ray receives the pixel's C-dim feature
    once (kernel :69-91); averaging by hit count happens at the end.

As in the JAX package, all pixels advance together through chunks of
``chunk`` samples, and the march stops once no pixel is still searching; in
torch that test is one host read per chunk. Accumulation is a sum per voxel
that gives the same bits on every run (``ops/voxelize.segment_sum``) in place
of the reference's atomicAdd; ``pred_mode``'s atomicMax is an order-free max.
The march and the accumulation run inside ``torch.profiler.record_function``
ranges, ``lift.first_hit`` and ``lift.accumulation``, which a profiler trace
reads for each stage's device time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from segsplat_tpu_torch.ops.voxelize import INT32_MIN, segment_sum


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32, device=device)


def _norm3(x, y, z) -> torch.Tensor:
    """√(x² + y² + z²) summed in that order, as XLA reduces a length-3 axis."""
    return torch.sqrt(x * x + y * y + z * z)


def pixel_ray_dirs(width: int, height: int, fx, fy, cx, cy,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """[H, W, 3] normalized camera-space ray directions; fx..cy are floats or
    0-dim tensors."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    u = ((xs[None, :] - cx) / fx).expand(height, width)
    v = ((ys[:, None] - cy) / fy).expand(height, width)
    d = torch.stack([u, v, torch.ones((height, width), device=device)], dim=-1)
    return d / _norm3(d[..., 0], d[..., 1], d[..., 2])[..., None]


@record_function("lift.first_hit")
def first_hit_voxels(occupancy: torch.Tensor,   # [Z,Y,X] int32, 0 = empty, else 1-based id
                     c2w: torch.Tensor,          # [4,4] camera-to-world
                     intrinsics: torch.Tensor,   # [4] (fx, fy, cx, cy)
                     grid_origin: torch.Tensor,  # [3] world origin of voxel (0,0,0)
                     voxel_size: torch.Tensor,   # []
                     depth_min: float, depth_max: float, ray_increment: torch.Tensor,
                     width: int, height: int, max_steps: int,
                     chunk: int = 32) -> torch.Tensor:
    """Per-pixel first-hit voxel id, [H, W] int32 (0 = no hit), on the
    occupancy's device. Each chunk takes the first valid step among its
    ``chunk`` samples (t < t_end and an occupied voxel); a pixel whose ray has
    passed t_end is marked -1; the march ends after ⌈max_steps/chunk⌉ chunks or
    once no pixel is 0; -1 reads as 0."""
    dev = occupancy.device
    Z, Y, X = occupancy.shape
    occ_flat = occupancy.reshape(-1)
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]

    cam_dirs = pixel_ray_dirs(width, height, fx, fy, cx, cy, dev).reshape(-1, 3)  # [P,3]
    R = c2w[:3, :3]
    cam_pos = c2w[:3, 3]
    world_dirs = cam_dirs @ R.T
    world_dirs = world_dirs / _norm3(world_dirs[:, 0], world_dirs[:, 1],
                                     world_dirs[:, 2])[:, None]

    depth_to_ray = 1.0 / cam_dirs[:, 2]                                      # [P]
    t_start = depth_to_ray * depth_min
    t_end = depth_to_ray * depth_max

    n_chunks = -(-max_steps // chunk)
    steps = torch.arange(chunk, dtype=torch.float32, device=dev) * ray_increment
    advance = chunk * ray_increment

    def probe(t):
        """t [P, S] ray lengths → hit ids [P, S] (0 if none or out of bounds)."""
        world = cam_pos + t[..., None] * world_dirs[:, None, :]             # [P,S,3]
        pos = torch.round((world - grid_origin) / voxel_size).to(torch.int32)
        inb = ((pos[..., 0] >= 0) & (pos[..., 0] < X) &
               (pos[..., 1] >= 0) & (pos[..., 1] < Y) &
               (pos[..., 2] >= 0) & (pos[..., 2] < Z))
        lin = pos[..., 2] * (Y * X) + pos[..., 1] * X + pos[..., 0]
        lin = torch.where(inb, lin, 0)
        return torch.where(inb, occ_flat[lin.long()], 0)

    hit = torch.zeros(t_start.shape, dtype=torch.int32, device=dev)
    active_t = t_start
    for _ in range(n_chunks):
        if not bool((hit == 0).any()):       # the JAX while_loop's condition
            break
        t = active_t[:, None] + steps[None, :]                               # [P,chunk]
        ids = probe(t)
        valid = (t < t_end[:, None]) & (ids > 0)
        any_hit = valid.any(dim=1)
        first = torch.argmax(valid.to(torch.uint8), dim=1)                   # first True
        chunk_hit = torch.where(any_hit, ids.gather(1, first[:, None])[:, 0], 0)
        hit = torch.where(hit == 0, chunk_hit, hit)
        # a ray that already passed t_end can never hit: the -1 sentinel
        exhausted = (active_t + advance) >= t_end
        hit = torch.where((hit == 0) & exhausted, -1, hit)
        active_t = active_t + advance
    return torch.clamp_min(hit, 0).reshape(height, width)


@record_function("lift.accumulation")
def scatter_features(features_2d: torch.Tensor,   # [H,W,C] float
                     hit_ids: torch.Tensor,       # [H,W] int32, 0 = miss
                     num_ids: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel feature sums [num_ids, C] f32 and hit counts [num_ids] int32;
    row 0 collects the misses with zero features (the reference also leaves row
    0 of its 1-based table unused). The same bits on every run."""
    C = features_2d.shape[-1]
    flat = features_2d.reshape(-1, C).to(torch.float32)
    ids = hit_ids.reshape(-1).long()
    hit = ids > 0
    sums = segment_sum(torch.where(hit[:, None], flat, 0.0), ids, num_ids)
    counts = torch.bincount(ids[hit], minlength=num_ids).to(torch.int32)
    return sums, counts


def scatter_predictions(preds_2d: torch.Tensor,   # [H,W] int32
                        hit_ids: torch.Tensor,    # [H,W] int32
                        num_ids: int) -> torch.Tensor:
    """pred_mode: the per-voxel max of int predictions (kernel :95-137); a voxel
    no pixel hit holds int32's minimum."""
    ids = hit_ids.reshape(-1).long()
    vals = torch.where(ids > 0, preds_2d.reshape(-1).to(torch.int32), INT32_MIN)
    out = torch.full((num_ids,), INT32_MIN, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce_(0, ids, vals, reduce="amax")


def default_max_steps(width, height, fx, fy, depth_min, depth_max,
                      ray_increment, cx=None, cy=None) -> int:
    """Static bound on ray-march steps: the worst-case depth_to_ray over the
    image. With cx/cy the farthest corner is max(c, W-1-c) pixels out, not W/2;
    an underestimate stops edge rays short of depth_max."""
    dx = max(float(cx), width - 1 - float(cx)) if cx is not None else width / 2
    dy = (max(float(cy), height - 1 - float(cy)) if cy is not None
          else height / 2)
    corner = np.sqrt((dx / fx) ** 2 + (dy / fy) ** 2 + 1.0)
    return int(np.ceil((depth_max - depth_min) * corner / ray_increment)) + 2


def lift_view(features_2d, occupancy: torch.Tensor, c2w, intrinsics, grid_origin,
              voxel_size, num_ids: int, depth_min: float = 0.01, depth_max: float = 10.0,
              ray_increment: Optional[float] = None, max_steps: Optional[int] = None,
              chunk: int = 32):
    """One view end to end on the occupancy's device: first-hit march and the
    feature scatter. ``ray_increment`` defaults to voxel_size/2, the
    reference's setting (debug_project_features.py:167-168). Returns
    (sums [num_ids, C], counts [num_ids])."""
    dev = occupancy.device
    H, W = features_2d.shape[:2]
    intr = _f32(intrinsics, dev)
    fx, fy = float(intr[0]), float(intr[1])
    if ray_increment is None:
        ray_increment = float(voxel_size) * 0.5
    if max_steps is None:
        max_steps = default_max_steps(W, H, fx, fy, depth_min, depth_max, ray_increment,
                                      cx=float(intr[2]), cy=float(intr[3]))
    hits = first_hit_voxels(occupancy, _f32(c2w, dev), intr, _f32(grid_origin, dev),
                            _f32(voxel_size, dev), depth_min, depth_max,
                            _f32(ray_increment, dev), W, H, max_steps, chunk)
    return scatter_features(_f32(features_2d, dev), hits, num_ids)


def lift_views_scan(features_2d: torch.Tensor,   # [V,H,W,C]
                    occupancy: torch.Tensor,     # [Z,Y,X] int32
                    c2ws: torch.Tensor,          # [V,4,4]
                    intrinsics: torch.Tensor,    # [V,4]
                    grid_origin: torch.Tensor, voxel_size: torch.Tensor,
                    depth_min: float, depth_max: float, ray_increment: torch.Tensor,
                    num_ids: int, max_steps: int, width: int, height: int,
                    chunk: int = 32):
    """Sums and counts over all views, accumulated view by view in device
    memory (the JAX package's lax.scan; the name is kept)."""
    C = features_2d.shape[-1]
    dev = occupancy.device
    sums = torch.zeros((num_ids, C), dtype=torch.float32, device=dev)
    counts = torch.zeros((num_ids,), dtype=torch.int32, device=dev)
    for feats, c2w, intr in zip(features_2d, c2ws, intrinsics):
        hits = first_hit_voxels(occupancy, c2w, intr, grid_origin, voxel_size,
                                depth_min, depth_max, ray_increment,
                                width, height, max_steps, chunk)
        s, c = scatter_features(feats, hits, num_ids)
        sums, counts = sums + s, counts + c
    return sums, counts


def mean_features(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """avg_feats = sums / max(counts, 1) (aggregate_voxel_features_onthefly.py:383-395)."""
    return sums / torch.clamp_min(counts, 1)[:, None].to(sums.dtype)
