#!/usr/bin/env python
"""Voxel grid from a Gaussian PLY without filters, the twin of the repo's
scripts/minkowski_voxel_grid_from_ply.py with the same flags. Host numpy and
scipy in both packages, no ``--device``.

    python -m segsplat_tpu_torch.minkowski_voxel_grid_from_ply --ply point_cloud.ply \\
        --output_dir OUT --cell_size 0.05
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from segsplat_tpu_torch.pipeline.voxel_grid import GridFilterConfig, build_voxel_grid, save_grid


def main(argv=None):
    p = ArgumentParser(description="Voxel grid from a Gaussian .ply (no filters)")
    p.add_argument("--ply", required=True)
    p.add_argument("--output_dir", default="output/minkowski_grid")
    p.add_argument("--cell_size", type=float, default=0.05)
    args = p.parse_args(argv)

    grid = build_voxel_grid(args.ply, GridFilterConfig(cell_size=args.cell_size),
                            advanced=False)
    base = os.path.splitext(os.path.basename(args.ply))[0]
    out = os.path.join(args.output_dir,
                       f"{base}_minkowski_{grid['stats']['voxels']}vox_grid.ply")
    save_grid(out, grid)
    print(f"[DONE] {grid['stats']} → {out}")
    return out


if __name__ == "__main__":
    main()
