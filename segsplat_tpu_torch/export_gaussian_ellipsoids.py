#!/usr/bin/env python
"""Gaussian → ellipsoid-mesh export, the twin of the repo's
scripts/export_gaussian_ellipsoids.py with the same flags (the reference's
export_gaussian_ellipsoids.py): a triangle-mesh PLY with one scaled, rotated
icosahedron per Gaussian, the most opaque first. Host numpy, no ``--device``.

    python -m segsplat_tpu_torch.export_gaussian_ellipsoids --ply point_cloud.ply \\
        --out ellipsoids.ply [--max_gaussians 20000 --scale_mult 1.0]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.core.transforms import qvec2rotmat
from segsplat_tpu_torch.io.ply import read_ply


def unit_icosphere():
    """Icosahedron vertices and faces (subdivision 0 keeps exports small)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    return v, f


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max_gaussians", type=int, default=20_000)
    p.add_argument("--scale_mult", type=float, default=1.0)
    args = p.parse_args(argv)

    c = read_ply(args.ply)
    xyz = c.xyz()
    scales = np.exp(np.stack([c[f"scale_{i}"] for i in range(3)], axis=1))
    quats = np.stack([c[f"rot_{i}"] for i in range(4)], axis=1)
    opac = 1 / (1 + np.exp(-np.asarray(c["opacity"])))
    if all(f"f_dc_{i}" in c.names for i in range(3)):
        cols = np.clip(np.stack([c[f"f_dc_{i}"] for i in range(3)], 1) * 0.2821 + 0.5, 0, 1)
    else:
        cols = np.full((len(xyz), 3), 0.5)

    keep = np.argsort(-opac)[:args.max_gaussians]
    sv, sf = unit_icosphere()
    n_v, n_f = len(sv), len(sf)
    verts = np.zeros((len(keep) * n_v, 6), np.float32)
    faces = np.zeros((len(keep) * n_f, 3), np.int32)
    for k, gi in enumerate(keep):
        R = qvec2rotmat(quats[gi] / (np.linalg.norm(quats[gi]) + 1e-12))
        verts[k * n_v:(k + 1) * n_v, :3] = (sv * scales[gi] * args.scale_mult) @ R.T + xyz[gi]
        verts[k * n_v:(k + 1) * n_v, 3:] = cols[gi]
        faces[k * n_f:(k + 1) * n_f] = sf + k * n_v

    _write_mesh(args.out, verts, faces)
    print(f"[DONE] {len(keep)} ellipsoids ({len(verts)} verts) → {args.out}")


def _write_mesh(path, verts, faces):
    """Binary little-endian PLY: float xyz and uchar RGB vertices, uchar-int
    triangle lists."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(verts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n").encode("ascii"))
        vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("r", "u1"), ("g", "u1"), ("b", "u1")])
        v = np.zeros(len(verts), vdt)
        v["x"], v["y"], v["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
        rgb = (verts[:, 3:] * 255).astype(np.uint8)
        v["r"], v["g"], v["b"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        f.write(v.tobytes())
        fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
        fa = np.zeros(len(faces), fdt)
        fa["n"] = 3
        fa["a"], fa["b"], fa["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
        f.write(fa.tobytes())


if __name__ == "__main__":
    main()
