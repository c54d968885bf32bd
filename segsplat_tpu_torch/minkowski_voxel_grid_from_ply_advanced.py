#!/usr/bin/env python
"""Advanced voxel-grid builder CLI, the twin of the repo's
scripts/minkowski_voxel_grid_from_ply_advanced.py with the same flags (the
reference's script/minkowski_voxel_grid_from_ply_advanced.py:10-21). The grid
stage is host numpy and scipy in both packages, so it takes no ``--device``.

    python -m segsplat_tpu_torch.minkowski_voxel_grid_from_ply_advanced \
        --ply point_cloud.ply --output_dir OUT --cell_size 0.04
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from segsplat_tpu_torch.pipeline.voxel_grid import GridFilterConfig, build_voxel_grid, save_grid


def main(argv=None):
    p = ArgumentParser(description="Advanced voxel grid generator from .ply "
                                   "with adaptive filtering")
    p.add_argument("--ply", required=True)
    p.add_argument("--output_dir", default="output/minkowski_grid")
    p.add_argument("--cell_size", type=float, default=0.05)
    p.add_argument("--density_eps", type=float, default=0.05)
    p.add_argument("--density_min_neighbors", type=int, default=10)
    p.add_argument("--opacity_threshold", type=float, default=0.9)
    p.add_argument("--scale_threshold", type=float, default=0.0)
    p.add_argument("--spikiness_threshold", type=float, default=10.0)
    p.add_argument("--adaptive_density", action="store_true")
    p.add_argument("--normal_consistency", type=float, default=0.9)
    p.add_argument("--normal_consistency_eps", type=float, default=0.05)
    p.add_argument("--normal_consistency_min_neighbors", type=int, default=5)
    args = p.parse_args(argv)

    cfg = GridFilterConfig(
        cell_size=args.cell_size, density_eps=args.density_eps,
        density_min_neighbors=args.density_min_neighbors,
        opacity_threshold=args.opacity_threshold,
        spikiness_threshold=args.spikiness_threshold,
        adaptive_density=args.adaptive_density,
        normal_consistency=args.normal_consistency,
        normal_consistency_eps=args.normal_consistency_eps,
        normal_consistency_min_neighbors=args.normal_consistency_min_neighbors)
    grid = build_voxel_grid(args.ply, cfg, advanced=True)
    base = os.path.splitext(os.path.basename(args.ply))[0]
    # filename carries the voxel count like the reference's _<N>vox_ convention
    out = os.path.join(args.output_dir,
                       f"{base}_minkowski_{grid['stats']['voxels']}vox_"
                       f"opac{args.opacity_threshold}_cell{args.cell_size}_"
                       f"eps{args.density_eps}_neig{args.density_min_neighbors}"
                       f"_grid.ply")
    save_grid(out, grid)
    print(f"[DONE] {grid['stats']} → {out}")
    return out


if __name__ == "__main__":
    main()
