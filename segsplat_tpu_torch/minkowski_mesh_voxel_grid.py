#!/usr/bin/env python
"""Mesh-sampled voxel grid, the twin of the repo's
scripts/minkowski_mesh_voxel_grid.py with the same flags (the reference's
script/minkowski_mesh_voxel_grid.py:38-62 Poisson-disk samples 200k points of
a mesh with Open3D and quantizes them): area-weighted triangle samples from
numpy's ``default_rng(seed)``, drawn in the JAX script's order so that the
samples are its samples, then quantized. Host numpy, no ``--device``.

    python -m segsplat_tpu_torch.minkowski_mesh_voxel_grid --mesh mesh.ply \\
        --output_dir OUT --num_samples 200000 --cell_size 0.04
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.ply import read_ply, write_voxel_grid_ply
from segsplat_tpu_torch.pipeline.hash_grid import MinkowskiVoxelGrid


def load_mesh(path: str):
    """Triangle mesh (vertices, faces) from a PLY with vertex and face elements."""
    c = read_ply(path)
    if c.faces is None:
        raise SystemExit(f"{path}: no face element — not a mesh PLY")
    return c.xyz(), np.asarray(c.faces)


def sample_mesh(vertices: np.ndarray, faces: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface samples."""
    rng = np.random.default_rng(seed)
    tri = vertices[faces]                                       # [F,3,3]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    fi = rng.choice(len(faces), size=n, p=area / area.sum())
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tri[fi]
    return (t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0])
            + v[:, None] * (t[:, 2] - t[:, 0])).astype(np.float32)


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--mesh", required=True, help="mesh PLY (vertices + faces)")
    p.add_argument("--output_dir", default="output/minkowski_mesh_grid")
    p.add_argument("--num_samples", type=int, default=200_000)
    p.add_argument("--cell_size", type=float, default=0.04)
    args = p.parse_args(argv)

    verts, faces = load_mesh(args.mesh)
    pts = sample_mesh(verts, faces, args.num_samples)
    grid = MinkowskiVoxelGrid(pts, None, voxel_size=args.cell_size)
    centers = grid.get_voxel_centers()
    cols = np.full((len(centers), 3), 180, np.uint8)
    out = os.path.join(args.output_dir, f"mesh_minkowski_grid_vox{len(centers)}.ply")
    write_voxel_grid_ply(out, centers, cols, args.cell_size, grid.grid_origin, binary=True)
    print(f"[DONE] {len(centers)} voxels → {out}")
    return out


if __name__ == "__main__":
    main()
