#!/usr/bin/env python
"""Voxel-grid PLY → dense occupancy tensor, the twin of the repo's
scripts/build_sparse_occupancy.py with the same flags plus ``--device`` (the
reference's cuda_project_image_to_sparse_voxel/build_sparse_occupancy.py:32-53:
1-based ids at round((p - origin)/voxel_size), negative coordinates shift the
origin). Writes {occupancy_3D, grid_origin, voxel_size} as .pt, or as .npz
for any other suffix.

    python -m segsplat_tpu_torch.build_sparse_occupancy --voxel_ply GRID.ply \\
        --output ALL_occupancy.pt [--device cuda|cpu]
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.core.types import VoxelGrid
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply
from segsplat_tpu_torch.ops.voxelize import occupancy_from_grid
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--voxel_ply", required=True)
    p.add_argument("--output", default="ALL_occupancy.pt")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the occupancy is built; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)

    centers, _colors, vs, origin, shape = read_voxel_grid_ply(args.voxel_ply)
    if vs is None:
        raise RuntimeError("missing voxel_size header comment")
    f32 = dict(dtype=torch.float32, device=device)
    grid = VoxelGrid(
        coords=torch.as_tensor(np.round((centers - origin) / vs).astype(np.int32),
                               device=device),
        origin=torch.as_tensor(origin, **f32), voxel_size=torch.tensor(vs, **f32),
        shape=shape or ())
    occ, occ_origin, occ_shape = occupancy_from_grid(grid)
    occ_np = occ.cpu().numpy()
    if args.output.endswith(".pt"):
        torch.save({"occupancy_3D": torch.from_numpy(occ_np),
                    "grid_origin": torch.from_numpy(occ_origin),
                    "voxel_size": float(vs)}, args.output)
    else:
        np.savez(args.output, occupancy_3D=occ_np, grid_origin=occ_origin,
                 voxel_size=float(vs))
    print(f"[DONE] occupancy {occ_shape}, {int((occ_np > 0).sum())} occupied "
          f"→ {args.output}")
    return occ_np


if __name__ == "__main__":
    main()
