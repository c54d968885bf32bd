"""The officescene room that stage 3 lifts into: the production run's
fabricated scene (``segsplat_tpu_torch/officescene_scale_run.py``, the twin
of ``scripts/officescene_scale_run.py``), with its distributions:

  * the geometry, fixed by the configuration: ``points`` centres from
    ``room_points`` (copied below, draw for draw) on NumPy's
    ``default_rng(layout_seed)``; stage 1's density filter (more than
    ``density_min_neighbors`` points within ``density_eps``, SciPy's
    cKDTree as ``pipeline/voxel_grid.density_mask``) and its floor
    quantisation to ``cell_size`` cells from the points' lowest corner
    (``quantize_to_grid``); the voxels are the occupied cells, in the
    sorted order of ``np.unique``, as stage 1 writes them to its grid PLY;
  * the 216 orbit cameras of ``fabricate``: radius 1.1 m, height
    1.3 + 0.15·sin 3θ, each looking at (0, 1.15, 0), with the lift's
    intrinsics (the native ``fx_native`` and centre scaled by
    ``downsample``);
  * drawn from ``--seed``, on the device: ``maps`` feature maps
    [channels, map_h, map_w], N(0, 1) in float16 as ``fabricate`` writes
    its one map, copied to pageable host memory as NumPy arrays (what
    ``np.load`` of an LSeg ``.npy`` gives the lift CLI).
"""

from __future__ import annotations

import numpy as np
import torch


def room_points(rng, n):
    """Gaussian centres shaped like a furnished room: floor, ceiling and wall
    shells plus 30 clutter blobs (``officescene_scale_run.room_points``)."""
    L, Hh, D = 3.6, 2.8, 3.6                       # room extents (m)
    counts = [int(n * f) for f in (0.14, 0.14, 0.10, 0.10, 0.07, 0.07)]
    u = rng.random
    walls = []
    k = counts[0]; walls.append(np.stack(          # floor / ceiling
        [u(k) * L - L / 2, np.zeros(k), u(k) * D - D / 2], 1))
    k = counts[1]; walls.append(np.stack(
        [u(k) * L - L / 2, np.full(k, Hh), u(k) * D - D / 2], 1))
    k = counts[2]; walls.append(np.stack(          # side walls
        [np.full(k, -L / 2), u(k) * Hh, u(k) * D - D / 2], 1))
    k = counts[3]; walls.append(np.stack(
        [np.full(k, L / 2), u(k) * Hh, u(k) * D - D / 2], 1))
    k = counts[4]; walls.append(np.stack(          # back / front walls
        [u(k) * L - L / 2, u(k) * Hh, np.full(k, -D / 2)], 1))
    k = counts[5]; walls.append(np.stack(
        [u(k) * L - L / 2, u(k) * Hh, np.full(k, D / 2)], 1))
    pts = [np.concatenate(walls) + rng.normal(0, 0.015, (sum(counts), 3))]
    remaining = n - sum(counts)                    # clutter: 30 furniture-like blobs
    blob_c = np.stack([u(30) * (L - 1) - (L - 1) / 2, u(30) * 1.2,
                       u(30) * (D - 1) - (D - 1) / 2], 1)
    per = remaining // 30
    for b in range(30):
        k = per if b < 29 else remaining - per * 29
        pts.append(blob_c[b] + rng.normal(0, 0.22, (k, 3)) * np.array([1.0, 0.6, 1.0]))
    p = np.concatenate(pts)
    # the camera corridor (xz-radius 1.1, y ≈ 1.3) is carved: clutter inside
    # the cylinder is pushed radially out to the 1.45 m shell
    r_xz = np.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2)
    inside = (r_xz < 1.45) & (p[:, 1] > 0.3) & (p[:, 1] < 2.4)
    scale = np.where(inside, (1.45 + 0.2 * rng.random(len(p))) / np.maximum(r_xz, 0.2), 1.0)
    p[:, 0] *= scale
    p[:, 2] *= scale
    p[:, 0] = np.clip(p[:, 0], -L / 2, L / 2)
    p[:, 2] = np.clip(p[:, 2], -D / 2, D / 2)
    return p[:n].astype(np.float32)


def voxels(config: dict):
    """The room's occupied cells, from ``layout_seed`` alone: (integer cell
    coordinates [V, 3] (x, y, z) int64, the grid's origin [3] float32, the
    cells' low corners [V, 3] float32, as stage 1's grid PLY holds them)."""
    from scipy.spatial import cKDTree

    pts = room_points(np.random.default_rng(int(config["layout_seed"])),
                      int(config["points"]))
    tree = cKDTree(pts)
    near = tree.query_ball_point(pts, r=float(config["density_eps"]), return_length=True)
    pts = pts[near > int(config["density_min_neighbors"])]
    cs = float(config["cell_size"])
    origin = pts.min(axis=0)
    cells = np.unique(np.floor((pts - origin) / cs).astype(np.int64), axis=0)
    return cells, origin.astype(np.float32), (cells * cs + origin).astype(np.float32)


def cameras(config: dict):
    """The orbit's camera-to-world matrices [views, 4, 4] and the lift's
    intrinsics (fx, fy, cx, cy) of the ray grid, float32."""
    n = int(config["views"])
    c2w = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([1.1 * np.sin(ang), 1.3 + 0.15 * np.sin(3 * ang), -1.1 * np.cos(ang)])
        fwd = np.array([0.0, 1.15, 0.0]) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        Rwc = np.stack([right, up, fwd], axis=0)
        c2w[i, :3, :3] = Rwc.T
        c2w[i, :3, 3] = pos
        c2w[i, 3, 3] = 1.0
    ds = float(config["downsample"])
    f = float(config["fx_native"])
    intr = np.array([f, f, config["native_w"] / 2, config["native_h"] / 2], np.float32) * ds
    return c2w, intr


def draw(config: dict, seed: int, device) -> dict:
    """The lift's inputs: ``cells``, ``origin``, ``centers`` (``voxels``),
    ``c2w`` and ``intrinsics`` (``cameras``), and ``maps``: ``maps``
    float16 NumPy arrays [channels, map_h, map_w] drawn from ``seed``."""
    cells, origin, centers = voxels(config)
    c2w, intr = cameras(config)
    g = torch.Generator(device).manual_seed(seed)
    shape = (int(config["channels"]), int(config["map_h"]), int(config["map_w"]))
    maps = [torch.randn(shape, generator=g, device=device).half().cpu().numpy()
            for _ in range(int(config["maps"]))]
    return {"cells": cells, "origin": origin, "centers": centers, "c2w": c2w,
            "intrinsics": intr, "maps": maps}
