"""Rendering split into image strips over the mesh's view ranks (the
counterpart of segsplat_tpu/parallel/render.py).

Alpha compositing is ordered along each ray, so splitting the Gaussians would
need depth-ordered merges of partial images; splitting the pixels needs none.
Strip i of n is the same camera with height/n rows, moved up by the strip's
first row; it keeps the whole frame's tan-FoV, so the frustum clamp of the
projection does not depend on the strip. Each rank renders its strip against
the whole Gaussian table, and an ``all_gather`` over the view ranks stacks
the strips.

Two differences from the JAX package, which renders a strip as the camera
with cy − row0 (``rasterize(tile_row0=...)`` here):
  * a strip bins with the frame's tile rows, so a Gaussian that the
    per-axis tile cap m truncates keeps in a strip the tiles it has in the
    whole frame. The JAX strip counts its m rows from the strip's top and
    differs from the whole frame there (ROADMAP Queue 3);
  * a strip's means are the frame's less row0, which is exact, where
    fy·y/z + (cy − row0) rounds otherwise than the frame's fy·y/z + cy and a
    pair-pixel at the α ≥ 1/255 cut can flip. So the strips are the frame's
    rows bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from segsplat_tpu_torch.ops.rasterize import TILE, rasterize
from segsplat_tpu_torch.parallel.mesh import VIEW_AXIS, Mesh


def strip_height(height: int, n_strips: int) -> int:
    """Rows of each of ``n_strips`` strips; raises unless they are TILE-aligned.
    (1080 is no multiple of 16, so no 1080-row frame splits.)"""
    if height % (n_strips * TILE):
        raise ValueError(f"height {height} must divide into {n_strips} TILE-aligned strips "
                         f"(a multiple of {n_strips * TILE})")
    return height // n_strips


def rasterize_strip(index: int, n_strips: int, means3d, scales, quats, opacities, colors,
                    viewmat, fx, fy, cx, cy, width: int, height: int, **kw) -> dict:
    """Strip ``index`` of ``n_strips`` of the width × height frame through
    ``rasterize`` (``kw`` are its keyword arguments): rows
    [index·height/n, (index+1)·height/n) of the frame's image and alpha."""
    strip_h = strip_height(height, n_strips)
    return rasterize(means3d, scales, quats, opacities, colors, viewmat,
                     fx, fy, cx, cy, width, strip_h,
                     tan_fovx=(0.5 * width) / fx, tan_fovy=(0.5 * height) / fy,
                     tile_row0=index * strip_h // TILE, **kw)


def rasterize_sharded(mesh: Mesh, means3d, scales, quats, opacities, colors,
                      viewmat, fx, fy, cx, cy, width: int, height: int,
                      bg: Optional[torch.Tensor] = None,
                      max_tiles_per_axis: int = 8, max_per_tile: int = 256,
                      backend: str = "cuda", tile_chunk: int = 64) -> dict:
    """The whole frame with its rows split over the mesh's view ranks: each
    rank renders strip ``view_index`` of ``n_view``. height must be a
    multiple of n_view·TILE. Returns {image [H, W, CH], alpha [H, W]} on every
    rank."""
    out = rasterize_strip(mesh.view_index, mesh.n_view, means3d, scales, quats, opacities,
                          colors, viewmat, fx, fy, cx, cy, width, height, bg=bg,
                          max_tiles_per_axis=max_tiles_per_axis,
                          max_per_tile=max_per_tile, tile_chunk=tile_chunk, backend=backend)
    return {"image": mesh.all_gather(out["image"], VIEW_AXIS, dim=0),
            "alpha": mesh.all_gather(out["alpha"], VIEW_AXIS, dim=0)}
