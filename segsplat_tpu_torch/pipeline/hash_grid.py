"""Adaptive spatial hash grid (the counterpart of segsplat_tpu/pipeline/hash_grid.py,
host numpy and scipy in both packages) — rebuild of the reference's HashGrid
(utils/hash_grid.py:1-740) and its regular-grid extraction, plus the
MinkowskiVoxelGrid facade (hash_grid.py:742-801, utils/standalone_minkowski.py).

Host-side preprocessing (numpy/scipy) like the reference, but every per-point
Python loop is replaced by vectorized passes: kNN stats via one cKDTree query,
cell assignment via lexsort-unique, overfull-cell subdivision as an iterative
level-split over ALL overfull cells at once instead of per-cell recursion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

_P1, _P2, _P3 = 73856093, 19349663, 83492791   # hash primes (hash_grid.py:160-171)


def hash_cell_coords(cell_coords: np.ndarray, hash_size: int = 2 ** 20) -> np.ndarray:
    """Prime-XOR spatial hash, bit-matching the reference (hash_grid.py:160-171)."""
    c = cell_coords.astype(np.int64)
    return ((c[:, 0] * _P1) ^ (c[:, 1] * _P2) ^ (c[:, 2] * _P3)) % hash_size


def knn_stats(points: np.ndarray, k: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(mean kNN distance, concentration in [0,1]) — compute_spatial_concentration
    (hash_grid.py:95-112)."""
    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1)
    mean_d = d[:, 1:].mean(axis=1)
    conc = 1.0 / (mean_d + 1e-6)
    return mean_d, conc / conc.max()


def local_density(points: np.ndarray, radius: float) -> np.ndarray:
    """Neighbor count within radius, normalized to [0,1]."""
    tree = cKDTree(points)
    counts = tree.query_ball_point(points, r=radius, return_length=True)
    counts = counts.astype(np.float64)
    return counts / max(counts.max(), 1.0)


def local_curvature(points: np.ndarray, normals: Optional[np.ndarray],
                    k: int = 8) -> np.ndarray:
    """1 − |mean neighbor-normal agreement| (compute_local_curvature analog);
    zeros when no normals are available."""
    if normals is None:
        return np.zeros(len(points))
    tree = cKDTree(points)
    _, idx = tree.query(points, k=k + 1)
    nb = normals[idx[:, 1:]]                                    # [N,k,3]
    agree = np.abs(np.einsum("nkd,nd->nk", nb, normals)).mean(axis=1)
    return 1.0 - agree


@dataclasses.dataclass
class AdaptiveHashGrid:
    """Adaptive-cell spatial hash (reference HashGrid).

    Cell sizes per point blend concentration/density/curvature
    (compute_adaptive_cell_sizes, hash_grid.py:114-149); overfull cells split
    octree-style (:173-198); queries search the 27-neighborhood (:353-446).
    """

    min_cell_size: float = 0.02
    max_cell_size: float = 0.2
    concentration_weight: float = 0.4
    density_weight: float = 0.3
    curvature_weight: float = 0.3
    hash_size: int = 2 ** 20
    max_points_per_cell: int = 64
    max_depth: int = 5
    filter_below_average: bool = False
    #   the reference's build unconditionally drops voxels holding fewer
    #   than the average point count (utils/hash_grid.py:331-337), which
    #   makes its kNN silently unable to see those points; here it is
    #   opt-in — enabling it marks the filtered points' cells as pruned
    #   (excluded from query_knn and build_structured_grid density).

    points: Optional[np.ndarray] = None
    cell_sizes: Optional[np.ndarray] = None
    cell_coords: Optional[np.ndarray] = None
    cell_levels: Optional[np.ndarray] = None
    _buckets: Optional[Dict] = None

    def compute_adaptive_cell_sizes(self, points: np.ndarray,
                                    normals: Optional[np.ndarray] = None,
                                    confidence: Optional[np.ndarray] = None
                                    ) -> np.ndarray:
        _, conc = knn_stats(points)
        dens = local_density(points, radius=self.max_cell_size)
        curv = local_curvature(points, normals)
        curv = curv / max(curv.max(), 1e-12)
        combined = (self.concentration_weight * (1 - conc)
                    + self.density_weight * (1 - dens)
                    + self.curvature_weight * (1 - curv))
        return (self.max_cell_size * (1.0 - combined)
                + self.min_cell_size * combined)

    def build(self, points: np.ndarray, normals: Optional[np.ndarray] = None,
              confidence: Optional[np.ndarray] = None) -> "AdaptiveHashGrid":
        points = np.asarray(points, np.float64)
        self.points = points
        self.cell_sizes = self.compute_adaptive_cell_sizes(points, normals,
                                                           confidence)
        # Per-point adaptive initial assignment (reference build,
        # hash_grid.py:301-303: cell_coords at each point's OWN cell size),
        # QUANTIZED onto the octree ladder max_cell_size/2^L. The reference's
        # arbitrary per-point sizes produce partially-overlapping boxes that
        # _resolve_voxel_intersections (:205-271) must subdivide pairwise at
        # O(n²); on the ladder, two occupied cells are either disjoint or
        # strictly nested (ancestor/descendant), so the subdivide-both branch
        # is resolved analytically up-front and only the reference's
        # ">80% overlap → keep the voxel with more points" rule remains,
        # which _resolve_nested_cells applies vectorized.
        with np.errstate(divide="ignore"):
            lad = np.log2(self.max_cell_size
                          / np.maximum(self.cell_sizes, 1e-12))
        levels = np.clip(np.round(lad), 0, self.max_depth).astype(np.int32)
        sizes = self.max_cell_size / (2.0 ** levels)
        coords = np.floor(points / sizes[:, None]).astype(np.int64)
        coords, levels = self._resolve_nested_cells(points, coords, levels)
        # split overfull cells level by level (all at once — the vectorized
        # form of _subdivide_voxel); whole cells move down together, so the
        # no-nesting invariant is preserved
        for depth in range(self.max_depth):
            key = self._key(coords, levels)
            _, inv, counts = np.unique(key, return_inverse=True,
                                       return_counts=True)
            overfull = ((counts[inv] > self.max_points_per_cell)
                        & (levels < self.max_depth))
            if not overfull.any():
                break
            size = self.max_cell_size / (2.0 ** (levels[overfull] + 1))
            coords[overfull] = np.floor(points[overfull] / size[:, None]
                                        ).astype(np.int64)
            levels[overfull] += 1
        self.cell_coords, self.cell_levels = coords, levels
        self._buckets = {}
        key = self._key(coords, levels)
        if self.filter_below_average:
            # reference parity (utils/hash_grid.py:331-337): prune cells
            # holding fewer than the average per-cell point count
            _, inv, counts = np.unique(key, return_inverse=True,
                                       return_counts=True)
            keep = counts[inv] >= counts.mean()
            self.pruned = ~keep
        else:
            self.pruned = np.zeros(len(points), bool)
        order = np.argsort(key, kind="stable")
        order = order[~self.pruned[order]]
        sk = key[order]
        if len(sk):
            starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
            ends = np.r_[starts[1:], len(sk)]
            for s, e in zip(starts, ends):
                self._buckets[sk[s]] = order[s:e]
        return self

    def _key(self, coords: np.ndarray, levels: np.ndarray) -> np.ndarray:
        return (hash_cell_coords(coords, self.hash_size)
                + levels.astype(np.int64) * self.hash_size)

    def _resolve_nested_cells(self, points: np.ndarray, coords: np.ndarray,
                              levels: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """The reference's _resolve_voxel_intersections (hash_grid.py:205-271)
        on the octree ladder: no occupied cell may have an occupied strict
        ancestor. For each nested pair, the voxel with MORE points wins
        (reference's >80%-overlap rule — on the ladder the smaller box is
        always 100% inside the bigger): the loser's points move INTO the
        winner's footprint (up into the ancestor cell, or down one level
        when the descendant wins) instead of being deleted from the index —
        the reference silently drops the loser's points from its hash table,
        which makes its kNN unsearchable for them; merging preserves the
        same no-overlap geometry without losing points (query_knn stays
        exact). Iterates to fixpoint with a forced upward merge as the
        bounded-iteration backstop."""
        max_iters = 2 * (self.max_depth + 1)
        for it in range(max_iters + 1):
            force_up = it == max_iters
            rec = np.rec.fromarrays(
                [levels.astype(np.int64), coords[:, 0], coords[:, 1],
                 coords[:, 2]], names=("l", "x", "y", "z"))
            uc, inv = np.unique(rec, return_inverse=True)
            counts = np.bincount(inv)
            occ = {(int(u.l), int(u.x), int(u.y), int(u.z)): k
                   for k, u in enumerate(uc)}
            # per-cell decision: -2 = stay, -1 = push down one level,
            # k >= 0 = absorb into unique cell k (its ancestor)
            decision = np.full(len(uc), -2, np.int64)
            for k, u in enumerate(uc):
                L = int(u.l)
                c = np.array([u.x, u.y, u.z], np.int64)
                for M in range(0, L):       # shallowest occupied ancestor
                    anc = tuple(np.floor_divide(c, 2 ** (L - M)))
                    j = occ.get((M,) + anc)
                    if j is None:
                        continue
                    if force_up or counts[j] >= counts[k]:
                        decision[k] = j     # descendant merges up
                    else:
                        decision[j] = -1    # ancestor pushes down a level
                    break
            # compress absorb chains (D→B while B→A must send D to A, or the
            # vacated middle cell stays occupied by D's points), and cancel
            # any absorb whose final target is itself pushing down this round
            # (a moving target; re-detected next iteration)
            for k in np.flatnonzero(decision >= 0):
                t = decision[k]
                while t >= 0 and decision[t] >= 0:
                    t = decision[t]     # targets are strictly shallower: no cycles
                decision[k] = -2 if decision[t] == -1 else t
            if not ((decision >= 0).any() or (decision == -1).any()):
                return coords, levels
            pd = decision[inv] == -1
            if pd.any():
                new_lv = levels[pd] + 1
                sz = self.max_cell_size / (2.0 ** new_lv)
                coords[pd] = np.floor(points[pd] / sz[:, None]).astype(np.int64)
                levels[pd] = new_lv.astype(np.int32)
            up = decision[inv] >= 0
            if up.any():
                tgt = decision[inv][up]
                levels[up] = uc.l[tgt].astype(np.int32)
                coords[up] = np.stack([uc.x[tgt], uc.y[tgt], uc.z[tgt]],
                                      axis=1).astype(np.int64)
        return coords, levels

    def nested_cell_conflicts(self) -> int:
        """Number of occupied cells with an occupied strict ancestor — the
        invariant _resolve_nested_cells enforces (0 after build)."""
        assert self.cell_coords is not None
        rec = np.rec.fromarrays(
            [self.cell_levels.astype(np.int64), self.cell_coords[:, 0],
             self.cell_coords[:, 1], self.cell_coords[:, 2]],
            names=("l", "x", "y", "z"))
        uc = np.unique(rec)
        occ = {(int(u.l), int(u.x), int(u.y), int(u.z)) for u in uc}
        bad = 0
        for u in uc:
            L = int(u.l)
            c = np.array([u.x, u.y, u.z], np.int64)
            for M in range(0, L):
                if (M,) + tuple(np.floor_divide(c, 2 ** (L - M))) in occ:
                    bad += 1
                    break
        return bad

    def query_knn(self, query: np.ndarray, k: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest stored points per query via 27-neighborhood candidate
        search (hash_grid.py:353-446), exact-checked with true distances."""
        assert self.points is not None, "build() first"
        query = np.atleast_2d(np.asarray(query, np.float64))
        out_d = np.full((len(query), k), np.inf)
        out_i = np.full((len(query), k), -1, np.int64)
        offs = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dz in (-1, 0, 1)], np.int64)
        for qi, q in enumerate(query):
            cand = []
            for lvl in np.unique(self.cell_levels):
                size = self.max_cell_size / (2.0 ** lvl)
                base = np.floor(q / size).astype(np.int64)
                keys = self._key(base[None] + offs,
                                 np.full(len(offs), lvl, np.int32))
                for key in np.unique(keys):
                    if key in self._buckets:
                        cand.append(self._buckets[key])
            if not cand:
                continue
            cand = np.unique(np.concatenate(cand))
            d = np.linalg.norm(self.points[cand] - q, axis=1)
            top = np.argsort(d)[:k]
            out_d[qi, :len(top)] = d[top]
            out_i[qi, :len(top)] = cand[top]
        return out_d, out_i

    def build_structured_grid(self, top_k_fraction: float = 0.5,
                              grid_cell: Optional[float] = None
                              ) -> Tuple[np.ndarray, float]:
        """Regular grid over the densest regions (build_structured_grid,
        hash_grid.py:683-735): keep cells whose point count is in the top-K
        densest, emit their centers on a uniform grid."""
        assert self.points is not None
        cell = grid_cell or self.max_cell_size
        coords = np.floor(self.points / cell).astype(np.int64)
        uniq, inv, counts = np.unique(coords, axis=0, return_inverse=True,
                                      return_counts=True)
        n_keep = max(int(len(uniq) * top_k_fraction), 1)
        keep = np.argsort(-counts)[:n_keep]
        centers = (uniq[keep] + 0.5) * cell
        return centers.astype(np.float32), cell


class MinkowskiVoxelGrid:
    """MinkowskiEngine-equivalent sparse quantization facade
    (hash_grid.py:742-801 wraps ME.SparseTensor; here it is sort-unique).

    Coordinates are floor(xyz / voxel_size); features average per voxel;
    get_voxel_centers returns (coord + 0.5)·voxel_size like the reference
    (:791-793)."""

    def __init__(self, points: np.ndarray, features: Optional[np.ndarray] = None,
                 voxel_size: float = 0.05):
        points = np.asarray(points, np.float64)
        self.voxel_size = float(voxel_size)
        coords = np.floor(points / voxel_size).astype(np.int64)
        self.coordinates, inv = np.unique(coords, axis=0, return_inverse=True)
        if features is not None:
            features = np.asarray(features, np.float64)
            sums = np.zeros((len(self.coordinates),) + features.shape[1:])
            np.add.at(sums, inv, features)
            counts = np.bincount(inv, minlength=len(self.coordinates))
            self.features = (sums / counts[:, None]).astype(np.float32)
        else:
            self.features = None
        self.inverse = inv

    def get_voxel_centers(self) -> np.ndarray:
        return ((self.coordinates + 0.5) * self.voxel_size).astype(np.float32)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        span = self.coordinates.max(axis=0) - self.coordinates.min(axis=0) + 1
        return tuple(int(s) for s in span)

    @property
    def grid_origin(self) -> np.ndarray:
        return (self.coordinates.min(axis=0) * self.voxel_size).astype(np.float32)
