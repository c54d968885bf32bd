"""Surface detection over trained Gaussians (the counterpart of
segsplat_tpu/pipeline/surface_detection.py, host numpy and scipy in both
packages) — rebuild of the reference's
SurfaceDetector (utils/surface_detection.py:34-227): opacity+scale pre-filter,
kNN-density scoring, DBSCAN spatial-concentration scoring, surface extraction
with PCA normal estimation (the reference uses Open3D for normals; here a
vectorized k-neighborhood PCA, no Open3D dependency)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


@dataclasses.dataclass
class SurfaceDetector:
    opacity_threshold: float = 0.7      # (:34-61)
    max_scale: float = 0.05
    density_k: int = 16                 # (:63-93)
    density_percentile: float = 30.0
    dbscan_eps: float = 0.1             # (:95-118)
    dbscan_min_samples: int = 10
    normal_k: int = 16                  # (:156-227)

    def prefilter(self, xyz: np.ndarray, opacity: np.ndarray,
                  scales: Optional[np.ndarray]) -> np.ndarray:
        """Opacity + scale mask (:34-61). opacity arrives as raw logits in
        checkpoint PLYs — sigmoid applied here like the reference."""
        op = 1.0 / (1.0 + np.exp(-np.asarray(opacity, np.float64).reshape(-1)))
        mask = op >= self.opacity_threshold
        if scales is not None:
            mask &= np.exp(scales).mean(axis=1) <= self.max_scale
        return mask

    def density_score(self, xyz: np.ndarray) -> np.ndarray:
        """Inverse mean kNN distance (:63-93)."""
        tree = cKDTree(xyz)
        d, _ = tree.query(xyz, k=min(self.density_k + 1, len(xyz)))
        return 1.0 / (d[:, 1:].mean(axis=1) + 1e-9)

    def concentration_score(self, xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """DBSCAN cluster labels + per-point score = cluster size fraction
        (:95-118); noise points score 0."""
        from sklearn.cluster import DBSCAN

        labels = DBSCAN(eps=self.dbscan_eps,
                        min_samples=self.dbscan_min_samples).fit_predict(xyz)
        score = np.zeros(len(xyz))
        for lab in np.unique(labels):
            if lab < 0:
                continue
            m = labels == lab
            score[m] = m.sum() / len(xyz)
        return score, labels

    def estimate_normals(self, xyz: np.ndarray) -> np.ndarray:
        """Smallest-eigenvector PCA normals over k-neighborhoods (the Open3D
        estimate_normals equivalent, :156-227), oriented consistently AWAY
        from the cloud centroid (outward for a roughly convex scene)."""
        tree = cKDTree(xyz)
        k = min(self.normal_k + 1, len(xyz))
        _, idx = tree.query(xyz, k=k)
        nb = xyz[idx]                                            # [N,k,3]
        centered = nb - nb.mean(axis=1, keepdims=True)
        cov = np.einsum("nki,nkj->nij", centered, centered) / k
        _, vecs = np.linalg.eigh(cov)                            # ascending
        normals = vecs[:, :, 0]
        # orient consistently away from the cloud centroid
        to_c = xyz - xyz.mean(axis=0)
        flip = np.einsum("nd,nd->n", normals, to_c) < 0
        normals[flip] = -normals[flip]
        return normals.astype(np.float32)

    def extract_surface(self, xyz: np.ndarray, opacity: np.ndarray,
                        scales: Optional[np.ndarray] = None) -> dict:
        """Full pipeline: prefilter → density percentile cut → DBSCAN keep
        clustered points → normals (:156-227). Returns dict with points,
        normals, mask (into the input), and the intermediate scores — BOTH
        scores are scattered to full input length (0 where not computed) so
        they index-align with ``xyz`` and ``mask``."""
        n = len(xyz)
        mask = self.prefilter(xyz, opacity, scales)
        pts = xyz[mask]
        density = np.zeros(n, np.float64)
        concentration = np.zeros(n, np.float64)
        if len(pts) < max(self.density_k + 1, self.dbscan_min_samples):
            return dict(points=pts, normals=np.zeros_like(pts),
                        mask=mask, density=density,
                        concentration=concentration)
        dens = self.density_score(pts)
        density[mask] = dens
        keep = dens >= np.percentile(dens, self.density_percentile)
        conc, labels = self.concentration_score(pts[keep])
        concentration[np.flatnonzero(mask)[keep]] = conc
        clustered = labels >= 0
        final_local = np.flatnonzero(mask)[np.flatnonzero(keep)[clustered]]
        final_mask = np.zeros(n, bool)
        final_mask[final_local] = True
        surf = xyz[final_mask]
        normals = (self.estimate_normals(surf) if len(surf) > 3
                   else np.zeros_like(surf, dtype=np.float32))
        return dict(points=surf.astype(np.float32), normals=normals,
                    mask=final_mask, density=density,
                    concentration=concentration)
