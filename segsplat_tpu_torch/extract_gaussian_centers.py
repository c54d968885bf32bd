#!/usr/bin/env python
"""Gaussian checkpoint PLY → centres .npy/.npz, the twin of the repo's
scripts/extract_gaussian_centers.py with the same flags (the reference's
voxel_to_gaussian/extract_gaussian_centers.py:15-50). A PLY read on the host
in both packages, so it takes no ``--device``.

    python -m segsplat_tpu_torch.extract_gaussian_centers --ply point_cloud.ply --out mu.npy
"""

from __future__ import annotations

from argparse import ArgumentParser

from segsplat_tpu_torch.pipeline.query import extract_gaussian_centers


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    mu = extract_gaussian_centers(args.ply, args.out)
    print(f"[DONE] {mu.shape[0]} centers → {args.out}")
    return mu


if __name__ == "__main__":
    main()
