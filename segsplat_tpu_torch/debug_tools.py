#!/usr/bin/env python
"""Data-sanity and visualization multitool, the twin of the repo's
scripts/debug_tools.py with the same seven sub-commands and flags (the
reference's debug_checks_scripts utilities: check_ply_fields,
check_ply_opacity_stats, inspect_pth_structure, analyze_voxel_hit_counts,
occupancy3D_to_ply, visualize_cameras, inspect_voxel_label_distribution).
Host only, no ``--device``.

    python -m segsplat_tpu_torch.debug_tools ply_fields|ply_opacity|pth_structure|\\
        hit_counts|label_distribution PATH
    python -m segsplat_tpu_torch.debug_tools occupancy_ply OCC.pt [--out occupancy.ply]
    python -m segsplat_tpu_torch.debug_tools cameras_ply SCENE [--out cameras.ply]
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.io.artifacts import load_semantics, load_voxel_features
from segsplat_tpu_torch.io.dataset import load_scene
from segsplat_tpu_torch.io.ply import read_ply, write_voxel_grid_ply


def cmd_ply_fields(args):
    c = read_ply(args.path)
    print(f"{len(c.vertex)} vertices; fields: {list(c.names)}")
    if c.faces is not None:
        print(f"{len(c.faces)} faces")
    for com in c.comments:
        print(f"comment: {com}")


def cmd_ply_opacity(args):
    op = np.asarray(read_ply(args.path)["opacity"], np.float64)
    sig = 1 / (1 + np.exp(-op))
    print(f"opacity (logit): min {op.min():.3f} max {op.max():.3f} mean {op.mean():.3f}")
    for t in (0.1, 0.5, 0.9, 0.99):
        print(f"  sigmoid > {t}: {(sig > t).mean() * 100:.1f}%")


def cmd_pth_structure(args):
    d = torch.load(args.path, map_location="cpu", weights_only=False)

    def walk(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif hasattr(x, "shape"):
            print(f"{prefix}: {tuple(x.shape)} {x.dtype}")
        else:
            print(f"{prefix}: {type(x).__name__} = {str(x)[:60]}")

    walk(d)


def cmd_hit_counts(args):
    f = np.asarray(load_voxel_features(args.path)["feat"], np.float32)
    norms = np.linalg.norm(f, axis=1)
    print(f"{len(f)} voxels, feat dim {f.shape[1]}")
    print(f"feature norms: min {norms.min():.3f} mean {norms.mean():.3f} "
          f"max {norms.max():.3f}; zero-vectors: {(norms == 0).sum()}")


def cmd_occupancy_ply(args):
    d = torch.load(args.path, map_location="cpu", weights_only=False)
    occ = (d["occupancy_3D"] if isinstance(d, dict) else d).numpy()
    vs = float(d.get("voxel_size", 1.0)) if isinstance(d, dict) else 1.0
    origin = (np.asarray(d["grid_origin"]) if isinstance(d, dict) and "grid_origin" in d
              else np.zeros(3, np.float32))
    nz = np.argwhere(occ > 0)
    centers = nz[:, ::-1].astype(np.float32) * vs + origin
    cols = np.full((len(centers), 3), 200, np.uint8)
    write_voxel_grid_ply(args.out, centers, cols, vs, origin)
    print(f"{len(centers)} occupied voxels → {args.out}")


def cmd_cameras_ply(args):
    """Camera centres and forward axes as a point PLY (visualize_cameras)."""
    info = load_scene(args.scene)
    pts, cols = [], []
    for cam in info.train_cameras + info.test_cameras:
        c = -cam.R @ cam.T
        pts.append(c)
        cols.append([255, 64, 64])
        fwd = cam.R[:, 2]
        for s in np.linspace(0.05, 0.3, 6):
            pts.append(c + s * fwd)
            cols.append([64, 64, 255])
    write_voxel_grid_ply(args.out, np.asarray(pts, np.float32),
                         np.asarray(cols, np.uint8), 0.0, np.zeros(3))
    print(f"{len(info.train_cameras) + len(info.test_cameras)} cameras → {args.out}")


def cmd_label_distribution(args):
    d = load_semantics(args.path)
    labels = d["labels"]
    prompts = [str(s) for s in d["prompts"]]
    uniq, counts = np.unique(labels, return_counts=True)
    for u, c in sorted(zip(uniq, counts), key=lambda x: -x[1]):
        name = prompts[u] if u < len(prompts) else str(u)
        print(f"  {name:24s} {c:8d} ({100 * c / len(labels):5.1f}%)")


COMMANDS = {"ply_fields": cmd_ply_fields, "ply_opacity": cmd_ply_opacity,
            "pth_structure": cmd_pth_structure, "hit_counts": cmd_hit_counts,
            "occupancy_ply": cmd_occupancy_ply, "cameras_ply": cmd_cameras_ply,
            "label_distribution": cmd_label_distribution}


def main(argv=None):
    p = ArgumentParser()
    sp = p.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        a = sp.add_parser(name)
        a.add_argument("scene" if name == "cameras_ply" else "path")
        if name in ("occupancy_ply", "cameras_ply"):
            a.add_argument("--out", default=name.replace("_ply", "") + ".ply")
    args = p.parse_args(argv)
    COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
