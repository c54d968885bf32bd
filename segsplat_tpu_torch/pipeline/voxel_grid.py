"""Sparse voxel-grid construction from a trained-Gaussian PLY (stage 1 of
run_pipeline.py), the counterpart of segsplat_tpu/pipeline/voxel_grid.py.

This stage runs on the host in numpy and scipy by design, in both packages: it
is preprocessing over a point cloud (kd-tree radius queries, a sort-unique),
not a CPU fallback of device code, so it takes no ``device``.

Rebuild of the reference's primary grid builders
(script/minkowski_voxel_grid_from_ply_advanced.py — filters at :60-135,
quantization at :136-151, metadata PLY at :173-205 — and the basic variant
minkowski_voxel_grid_from_ply.py). Same filters, same defaults, same output PLY
dialect (header comments carry voxel_size/grid_origin/grid_shape).

The reference loops per point in Python over cKDTree query_ball_point for the
density and normal filters; here every filter is a vectorized pass
(query_ball_point(return_length=True) / query_pairs) — host-side preprocessing,
so scipy is the right tool; the per-voxel color means use a segment mean instead
of the reference's per-voxel Python loop (:145-151).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from segsplat_tpu_torch.io.ply import read_ply, write_voxel_grid_ply


@dataclasses.dataclass
class GridFilterConfig:
    """Defaults = the reference CLI defaults (from_ply_advanced.py:10-21)."""
    cell_size: float = 0.05
    density_eps: float = 0.05
    density_min_neighbors: int = 10
    opacity_threshold: float = 0.9      # rank-based keep of top (1-t) fraction
    spikiness_threshold: float = 10.0
    adaptive_density: bool = False
    normal_consistency: float = 0.9
    normal_consistency_eps: float = 0.05
    normal_consistency_min_neighbors: int = 5


def load_gaussian_cloud(ply_path: str) -> dict:
    """Extract xyz / colors(SH-DC clipped to u8) / opacity / scales / normals from
    a Gaussian checkpoint PLY (from_ply_advanced.py:33-59)."""
    c = read_ply(ply_path)
    names = c.names
    xyz = c.xyz().astype(np.float32)
    if all(f"f_dc_{i}" in names for i in range(3)):
        cols = np.stack([np.clip(c[f"f_dc_{i}"], 0, 1) * 255 for i in range(3)],
                        axis=1).astype(np.uint8)
    elif "red" in names:
        cols = np.stack([c["red"], c["green"], c["blue"]], axis=1).astype(np.uint8)
    else:
        cols = np.full((len(xyz), 3), 127, np.uint8)
    opacity = (np.asarray(c["opacity"], np.float32)
               if "opacity" in names else np.ones(len(xyz), np.float32))
    scale_names = [f"scale_{i}" for i in range(3) if f"scale_{i}" in names]
    scales_vec = (np.stack([c[n] for n in scale_names], axis=1).astype(np.float32)
                  if scale_names else None)
    normals = None
    if all(n in names for n in ("nx", "ny", "nz")):
        normals = np.stack([c["nx"], c["ny"], c["nz"]], axis=1).astype(np.float32)
        norms = np.linalg.norm(normals, axis=1, keepdims=True) + 1e-8
        normals = normals / norms
    return dict(xyz=xyz, colors=cols, opacity=opacity, scales_vec=scales_vec,
                normals=normals)


def spikiness_mask(scales_vec: np.ndarray, threshold: float) -> np.ndarray:
    """max/min scale ratio filter (:60-72). Scales arrive log-space in checkpoint
    PLYs; the reference ratios them as-is, so we do too."""
    s = np.clip(scales_vec, 1e-6, None)
    return (s.max(axis=1) / s.min(axis=1)) < threshold


def opacity_rank_top(opacity: np.ndarray, opacity_threshold: float) -> np.ndarray:
    """Indices of the top (1 - threshold) fraction by opacity, descending (:81-96)."""
    keep_fraction = 1.0 - opacity_threshold
    n_keep = max(int(opacity.shape[0] * keep_fraction), 1)
    top = np.argpartition(opacity, -n_keep)[-n_keep:]
    return top[np.argsort(-opacity[top])]


def normal_consistency_mask(xyz: np.ndarray, normals: np.ndarray, min_dot: float,
                            eps: float, min_neighbors: int) -> np.ndarray:
    """Keep points with ≥ min_neighbors radius-neighbors whose normals agree
    (dot > min_dot) (:97-117) — vectorized over query_pairs."""
    tree = cKDTree(xyz)
    pairs = tree.query_pairs(eps, output_type="ndarray")
    consistent = np.zeros(len(xyz), np.int64)
    neighbor_count = np.zeros(len(xyz), np.int64)
    if len(pairs):
        i, j = pairs[:, 0], pairs[:, 1]
        dots = np.einsum("ij,ij->i", normals[i], normals[j])
        agree = (dots > min_dot).astype(np.int64)
        np.add.at(consistent, i, agree)
        np.add.at(consistent, j, agree)
        np.add.at(neighbor_count, i, 1)
        np.add.at(neighbor_count, j, 1)
    # the reference counts the point itself via query_ball_point (dot(self)=1>t)
    consistent += 1
    neighbor_count += 1
    return (neighbor_count >= min_neighbors) & (consistent >= min_neighbors)


def density_mask(xyz: np.ndarray, eps, min_neighbors: int) -> np.ndarray:
    """Radius-density filter (:24-28, :119-135): strictly more than min_neighbors
    points (incl. self) within eps. eps may be per-point (adaptive mode)."""
    tree = cKDTree(xyz)
    if np.isscalar(eps):
        counts = tree.query_ball_point(xyz, r=float(eps), return_length=True)
    else:
        counts = np.array([tree.query_ball_point(p, r=float(e), return_length=True)
                           for p, e in zip(xyz, eps)])
    return counts > min_neighbors


def quantize_to_grid(points: np.ndarray, colors: np.ndarray, cell_size: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int, int]]:
    """floor((p - min)/cell) unique-voxelization with per-voxel mean color
    (:136-151). Returns (centers, colors u8, origin, grid_shape xyz)."""
    origin = points.min(axis=0)
    vidx = np.floor((points - origin) / cell_size).astype(np.int64)
    uniq, inverse = np.unique(vidx, axis=0, return_inverse=True)
    centers = (uniq * cell_size + origin).astype(np.float32)
    sums = np.zeros((len(uniq), 3), np.float64)
    np.add.at(sums, inverse, colors.astype(np.float64))
    counts = np.bincount(inverse, minlength=len(uniq))[:, None]
    vox_colors = (sums / np.maximum(counts, 1)).astype(np.uint8)
    shape = tuple(int(s) for s in (uniq.max(axis=0) + 1)) if len(uniq) else (0, 0, 0)
    return centers, vox_colors, origin.astype(np.float32), shape


def build_voxel_grid(ply_path: str, cfg: GridFilterConfig,
                     advanced: bool = True) -> dict:
    """Full filter chain → sparse grid. ``advanced=False`` reproduces the basic
    builder (minkowski_voxel_grid_from_ply.py): quantize only, centers at
    +voxel_size/2."""
    cloud = load_gaussian_cloud(ply_path)
    xyz, colors = cloud["xyz"], cloud["colors"]
    opacity, scales_vec, normals = (cloud["opacity"], cloud["scales_vec"],
                                    cloud["normals"])
    stats = {"input": len(xyz)}

    if advanced:
        if scales_vec is not None:
            m = spikiness_mask(scales_vec, cfg.spikiness_threshold)
            xyz, colors, opacity = xyz[m], colors[m], opacity[m]
            scales_vec = scales_vec[m]
            normals = normals[m] if normals is not None else None
            stats["after_spikiness"] = len(xyz)

        top = opacity_rank_top(opacity, cfg.opacity_threshold)
        xyz, colors, opacity = xyz[top], colors[top], opacity[top]
        scales_vec = scales_vec[top] if scales_vec is not None else None
        normals = normals[top] if normals is not None else None
        stats["after_opacity"] = len(xyz)

        if normals is not None and cfg.normal_consistency < 1.0:
            m = normal_consistency_mask(xyz, normals, cfg.normal_consistency,
                                        cfg.normal_consistency_eps,
                                        cfg.normal_consistency_min_neighbors)
            xyz, colors, opacity = xyz[m], colors[m], opacity[m]
            scales_vec = scales_vec[m] if scales_vec is not None else None
            stats["after_normals"] = len(xyz)

        if cfg.adaptive_density and scales_vec is not None:
            eps = np.clip(np.abs(scales_vec.mean(axis=1)),
                          cfg.density_eps / 2, cfg.density_eps * 2)
        else:
            eps = cfg.density_eps
        m = density_mask(xyz, eps, cfg.density_min_neighbors)
        xyz, colors = xyz[m], colors[m]
        stats["after_density"] = len(xyz)

    if len(xyz) == 0:
        raise ValueError(
            f"all gaussians filtered out ({stats}) — relax opacity_threshold/"
            f"density_eps/density_min_neighbors")
    centers, vox_colors, origin, shape = quantize_to_grid(xyz, colors,
                                                          cfg.cell_size)
    if not advanced:
        centers = centers + cfg.cell_size / 2.0  # basic variant convention (:63)
    stats["voxels"] = len(centers)
    return dict(centers=centers, colors=vox_colors, voxel_size=cfg.cell_size,
                origin=origin, shape=shape, stats=stats)


def save_grid(out_path: str, grid: dict, binary: bool = False) -> None:
    write_voxel_grid_ply(out_path, grid["centers"], grid["colors"],
                         grid["voxel_size"], grid["origin"],
                         grid_shape=grid["shape"], binary=binary)
