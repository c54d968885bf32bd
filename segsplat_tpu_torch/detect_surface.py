#!/usr/bin/env python
"""Surface detection CLI, the twin of the repo's scripts/detect_surface.py with
the same flags (the reference's script/detect_surface.py /
detect_surface_NEW_ply.py): surface points and normals of a trained Gaussian
PLY, written as a normals-bearing point PLY. ``pipeline/surface_detection``
is host numpy, scipy and scikit-learn in both packages, so no ``--device``.

    python -m segsplat_tpu_torch.detect_surface --ply point_cloud.ply --out surface.ply
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.ply import write_ply
from segsplat_tpu_torch.pipeline.surface_detection import SurfaceDetector
from segsplat_tpu_torch.pipeline.voxel_grid import load_gaussian_cloud


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--opacity_threshold", type=float, default=0.7)
    p.add_argument("--max_scale", type=float, default=0.05)
    p.add_argument("--density_k", type=int, default=16)
    p.add_argument("--density_percentile", type=float, default=30.0)
    p.add_argument("--dbscan_eps", type=float, default=0.1)
    p.add_argument("--dbscan_min_samples", type=int, default=10)
    args = p.parse_args(argv)

    cloud = load_gaussian_cloud(args.ply)
    det = SurfaceDetector(
        opacity_threshold=args.opacity_threshold, max_scale=args.max_scale,
        density_k=args.density_k, density_percentile=args.density_percentile,
        dbscan_eps=args.dbscan_eps, dbscan_min_samples=args.dbscan_min_samples)
    log_scales = (np.log(np.clip(cloud["scales_vec"], 1e-9, None))
                  if cloud["scales_vec"] is not None else None)
    out = det.extract_surface(cloud["xyz"], cloud["opacity"], log_scales)
    pts, normals = out["points"], out["normals"]

    dt = np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                   ("nx", "f4"), ("ny", "f4"), ("nz", "f4")])
    v = np.zeros(len(pts), dt)
    v["x"], v["y"], v["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    v["nx"], v["ny"], v["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    write_ply(args.out, v, binary=True)
    print(f"[DONE] {len(pts)} surface points (of {len(cloud['xyz'])}) → {args.out}")
    return out


if __name__ == "__main__":
    main()
