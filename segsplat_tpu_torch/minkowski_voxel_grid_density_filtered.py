#!/usr/bin/env python
"""Density-filtered voxel-grid builder, the twin of the repo's
scripts/minkowski_voxel_grid_density_filtered.py with the same flags (the
reference's script/minkowski_voxel_grid_density_filtered.py): the opacity
rank and radius-density filters, then quantization. Host numpy and scipy in
both packages, no ``--device``.

    python -m segsplat_tpu_torch.minkowski_voxel_grid_density_filtered \\
        --ply point_cloud.ply --output_dir OUT --cell_size 0.05
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from segsplat_tpu_torch.pipeline.voxel_grid import (density_mask, load_gaussian_cloud,
                                                    opacity_rank_top, quantize_to_grid,
                                                    save_grid)


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True)
    p.add_argument("--output_dir", default="output/minkowski_grid")
    p.add_argument("--cell_size", type=float, default=0.05)
    p.add_argument("--density_eps", type=float, default=0.05)
    p.add_argument("--density_min_neighbors", type=int, default=10)
    p.add_argument("--opacity_threshold", type=float, default=0.9)
    args = p.parse_args(argv)

    cloud = load_gaussian_cloud(args.ply)
    xyz, colors, opacity = cloud["xyz"], cloud["colors"], cloud["opacity"]
    top = opacity_rank_top(opacity, args.opacity_threshold)
    xyz, colors = xyz[top], colors[top]
    m = density_mask(xyz, args.density_eps, args.density_min_neighbors)
    xyz, colors = xyz[m], colors[m]
    centers, vox_colors, origin, shape = quantize_to_grid(xyz, colors, args.cell_size)
    base = os.path.splitext(os.path.basename(args.ply))[0]
    out = os.path.join(args.output_dir,
                       f"{base}_minkowski_{len(centers)}vox_density_grid.ply")
    save_grid(out, dict(centers=centers, colors=vox_colors, voxel_size=args.cell_size,
                        origin=origin, shape=shape))
    print(f"[DONE] {len(centers)} voxels → {out}")
    return out


if __name__ == "__main__":
    main()
