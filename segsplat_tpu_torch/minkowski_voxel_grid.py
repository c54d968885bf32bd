#!/usr/bin/env python
"""Voxel-grid builder with an auto-tuned voxel size, the twin of the repo's
scripts/minkowski_voxel_grid.py with the same flags (the reference's
script/minkowski_voxel_grid.py): keeps the Gaussians above an opacity, tunes
the voxel size toward a target voxel count (:78-91, 105) and writes a binary
metadata PLY (:153-176). Host numpy in both packages, no ``--device``.

    python -m segsplat_tpu_torch.minkowski_voxel_grid --ply point_cloud.ply \\
        --output_dir OUT [--voxel_size 0 --target_voxels 100000]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.ply import write_voxel_grid_ply
from segsplat_tpu_torch.pipeline.hash_grid import MinkowskiVoxelGrid
from segsplat_tpu_torch.pipeline.voxel_grid import load_gaussian_cloud


def auto_voxel_size(points: np.ndarray, target_voxels: int, iters: int = 12) -> float:
    """Bisect the cell size until the unique-voxel count is ~target (:78-91)."""
    span = points.max(axis=0) - points.min(axis=0)
    lo, hi = span.max() / 4096.0, span.max()
    for _ in range(iters):
        mid = (lo + hi) / 2
        n = len(np.unique(np.floor(points / mid).astype(np.int64), axis=0))
        if n > target_voxels:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True, help="gaussian checkpoint PLY")
    p.add_argument("--output_dir", default="output/minkowski_grid")
    p.add_argument("--voxel_size", type=float, default=0.0,
                   help="0 = auto-tune toward --target_voxels")
    p.add_argument("--target_voxels", type=int, default=100_000)
    p.add_argument("--opacity_threshold", type=float, default=0.5)
    args = p.parse_args(argv)

    cloud = load_gaussian_cloud(args.ply)
    xyz, colors, opacity = cloud["xyz"], cloud["colors"], cloud["opacity"]
    keep = (1.0 / (1.0 + np.exp(-opacity))) >= args.opacity_threshold
    xyz, colors = xyz[keep], colors[keep]
    print(f"[INFO] {keep.sum()} / {len(keep)} gaussians above opacity "
          f"{args.opacity_threshold}")

    vs = args.voxel_size or auto_voxel_size(xyz, args.target_voxels)
    grid = MinkowskiVoxelGrid(xyz, colors.astype(np.float32), voxel_size=vs)
    centers = grid.get_voxel_centers()
    cols = (grid.features.clip(0, 255).astype(np.uint8) if grid.features is not None
            else np.full((len(centers), 3), 127, np.uint8))

    base = os.path.splitext(os.path.basename(args.ply))[0]
    out = os.path.join(args.output_dir, f"{base}_minkowski_{len(centers)}vox_grid.ply")
    write_voxel_grid_ply(out, centers, cols, vs, grid.grid_origin, binary=True)
    print(f"[DONE] {len(centers)} voxels @ {vs:.5f} → {out}")
    return out


if __name__ == "__main__":
    main()
