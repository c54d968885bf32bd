"""Plain PyTorch reference of stage 3's lift: one view's feature map lifted
into its rays' first occupied voxels. It imports nothing of the program.

The semantics are those of the reference system's ray-march kernel
(``cuda_project_image_to_sparse_voxel/project_image_cuda_kernel.cu:31-91``,
called by ``aggregate_voxel_features_onthefly.py``):

  * the ray of pixel (x, y), at integer pixel coordinates, has the camera
    direction d = normalize(((x - cx)/fx, (y - cy)/fy, 1)) and the world
    direction R·d (R the camera-to-world rotation);
  * it is sampled at t_k = depth_min/d_z + k·increment, k = 0, 1, ..., while
    t_k < depth_max/d_z, at the world points o + t_k·R·d;
  * a sample lands in the voxel round((p - origin)/voxel_size) of a dense
    occupancy of the grid's cells (1-based ids in the grid's order); the
    first sample that lands in an occupied cell is the ray's hit;
  * each hit ray adds its pixel's features once, and a count, into its voxel.

The feature map is resized to the ray grid as the lift documents its resize:
bilinear with half-pixel centres, antialiased when it shrinks
(``F.interpolate(..., antialias=True)``, ``jax.image.resize``'s "bilinear").
``map_dtype`` rounds the resized map to another precision before the sums
(the control uses bfloat16).

Departures from the CUDA kernel: the kernel transforms the camera point t·d
by the 4×4 camera-to-world matrix at each step and steps t by repeated
additions of the increment, where this forms o + t·(R·d) with t = t_0 +
k·increment (other roundings of the same points); the kernel reads an int64
occupancy of every view's batch, this an int32 grid; it adds with atomicAdd
in whatever order its threads finish, this with ``index_add_`` in blocks of
rays (on the card also in no fixed order, so the sums' last bits may differ
between runs). Rays run in blocks of ``BLOCK`` and samples in chunks of
``CHUNK``, so that a 876×584 view fits.

``view_bytes`` and ``view_ops`` count the work a view needs, whatever
implements it, for the roofline readers: the fp16 map read once, the hit
voxels' float32 rows and int32 counts read and written once; one add a hit
ray and channel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 1 << 16          # rays a block
CHUNK = 32               # samples a ray marches at a time


def no_tf32() -> None:
    """float32 matrix products in float32: the reference is plain float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def occupancy(cells: torch.Tensor) -> torch.Tensor:
    """A dense [X, Y, Z] int32 grid: cell ``cells[i]`` (non-negative integer
    coordinates) holds id i + 1, every other cell 0."""
    cells = cells.long()
    dims = (cells.max(dim=0).values + 1).tolist()
    occ = torch.zeros(dims, dtype=torch.int32, device=cells.device)
    occ[cells[:, 0], cells[:, 1], cells[:, 2]] = torch.arange(
        1, cells.shape[0] + 1, dtype=torch.int32, device=cells.device)
    return occ


def march(occ: torch.Tensor, origin: torch.Tensor, voxel_size: float, c2w: torch.Tensor,
          intrinsics, width: int, height: int, depth_min: float, depth_max: float,
          increment: float) -> torch.Tensor:
    """Each ray's first-hit voxel id, [height·width] int64 in raster order (0:
    no hit), on ``occ``'s device. A block's rays march a chunk of samples at
    a time; those that hit, or whose next chunk starts past the end, drop
    out."""
    no_tf32()
    dev = occ.device
    f32 = dict(dtype=torch.float32, device=dev)
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    R, o = c2w[:3, :3].to(**f32), c2w[:3, 3].to(**f32)
    origin = origin.to(**f32)
    flat = occ.reshape(-1)
    # cell (x, y, z) → its index in ``flat``, exact in float32 below 2^24 cells
    if flat.numel() >= 1 << 24:
        raise ValueError(f"an occupancy of {flat.numel()} cells: indices past float32's")
    sx, sy = float(occ.shape[1] * occ.shape[2]), float(occ.shape[2])
    top = torch.tensor(occ.shape, **f32) - 1
    ys, xs = torch.meshgrid(torch.arange(height, **f32), torch.arange(width, **f32),
                            indexing="ij")
    d = torch.stack([(xs.reshape(-1) - cx) / fx, (ys.reshape(-1) - cy) / fy,
                     torch.ones(height * width, **f32)], dim=1)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    out = torch.zeros(height * width, dtype=torch.int64, device=dev)
    steps = torch.arange(CHUNK, **f32)
    for b0 in range(0, height * width, BLOCK):
        db = d[b0:b0 + BLOCK]
        t0, t_end = depth_min / db[:, 2], depth_max / db[:, 2]
        dw = db @ R.T
        live = torch.arange(db.shape[0], device=dev)
        k0 = 0
        while live.numel():
            t = t0[live, None] + (k0 + steps)[None, :] * increment              # [L, S]
            p = o + t[..., None] * dw[live, None, :]
            idx = torch.round((p - origin) / voxel_size)
            inb = ((idx >= 0) & (idx <= top)).all(dim=-1) & (t < t_end[live, None])
            lin = idx[..., 0] * sx + idx[..., 1] * sy + idx[..., 2]
            ids = torch.where(inb, flat[lin.long().clamp_(0, flat.numel() - 1)], 0)
            hit = ids.gather(1, (ids > 0).long().argmax(dim=1, keepdim=True))[:, 0]
            out[b0 + live] = hit.long()
            k0 += CHUNK
            live = live[(hit == 0) & (t0[live] + k0 * increment < t_end[live])]
    return out


def resize(fmap: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[C, h, w] → [C, height, width] float32 (the module docstring)."""
    return F.interpolate(fmap.to(torch.float32)[None], size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)[0]


def lift_view(fmap: torch.Tensor, hits: torch.Tensor, num_ids: int,
              map_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view's (sums [num_ids, C] float32, counts [num_ids] int64): the
    resized map's [C, H, W] features of each hit ray (``hits`` [H·W]) added
    into its voxel; row 0 stays 0."""
    no_tf32()
    C, H, W = fmap.shape[0], fmap.shape[1], fmap.shape[2]
    feats = fmap.reshape(C, H * W)
    if map_dtype != torch.float32:
        feats = feats.to(map_dtype).to(torch.float32)
    sums = torch.zeros((num_ids, C), dtype=torch.float32, device=fmap.device)
    for b0 in range(0, H * W, BLOCK):
        h = hits[b0:b0 + BLOCK]
        sel = torch.nonzero(h).reshape(-1)
        sums.index_add_(0, h[sel], feats[:, b0:b0 + BLOCK][:, sel].T)
    counts = torch.bincount(hits[hits > 0], minlength=num_ids)
    counts[0] = 0
    return sums, counts


def view_bytes(channels: int, map_h: int, map_w: int, voxels_hit: int) -> int:
    """Bytes a view needs: its fp16 map read once, and each hit voxel's float32
    row and int32 count read and written once."""
    return channels * map_h * map_w * 2 + voxels_hit * (channels * 4 + 4) * 2


def view_ops(rays_hit: int, channels: int) -> int:
    """Operations a view needs: one add a hit ray and channel."""
    return rays_hit * channels
