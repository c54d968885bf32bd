#!/usr/bin/env python
"""Gaussian pre-filter keeping the Gaussians within ``max_dist`` of a voxel or
mesh point set, the twin of the repo's scripts/dist_to_mesh_filter.py with
the same flags (the reference's betterGaussians/dist_to_mesh_filter.py:16-40).
A scipy k-d tree on the host, no ``--device``.

    python -m segsplat_tpu_torch.dist_to_mesh_filter --ply point_cloud.ply \\
        --ref_ply grid.ply --out kept.ply [--max_dist 0.05]
"""

from __future__ import annotations

from argparse import ArgumentParser

from scipy.spatial import cKDTree

from segsplat_tpu_torch.io.ply import read_ply, write_ply


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True, help="Gaussian checkpoint PLY")
    p.add_argument("--ref_ply", required=True, help="voxel/mesh point set PLY")
    p.add_argument("--out", required=True)
    p.add_argument("--max_dist", type=float, default=0.05)
    args = p.parse_args(argv)

    c = read_ply(args.ply)
    d, _ = cKDTree(read_ply(args.ref_ply).xyz()).query(c.xyz(), k=1)
    mask = d <= args.max_dist
    write_ply(args.out, c.vertex[mask], binary=True)
    print(f"[DONE] kept {mask.sum()} / {len(c.vertex)} gaussians → {args.out}")
    return mask


if __name__ == "__main__":
    main()
