"""Post-train codebook-class consolidation: the port's copy of
segsplat_tpu/pipeline/consolidate.py (numpy on the host in both packages; the
same remap bit for bit).

The SLIC+track pseudo-labeler produces region-level ids — one physical object
trains into SEVERAL codebook classes (the reference's DEVA produces
object-level ids, Tracking-Anything-with-DEVA). The reference's own query
protocol absorbs the split with IoA grouping (`select_obj_ioa`,
train/editing.py), but the strict 1-1 identity protocol punishes it.

This pass merges codebook classes using the trained model itself — no labels,
no images: fragments of one object are (a) spatially interleaved in 3D (their
Gaussians are mutual neighbors) and (b) agree in learned identity-feature
space across the whole scene, while distinct objects — even same-colored
ones — occupy disjoint 3D supports. Mask-IoU-only merging (the in-clip
consensus measured in round 3) lacks signal (b) and cost the grouped protocol
−0.04; here spatial mixing is the primary criterion and codebook-feature
agreement the gate.

Algorithm:
  1. classify every active Gaussian: argmax over `code_book @ identity_feat`
     (the render_lerf_mask.py / voxeltoGaussian classification, applied at
     the Gaussian rather than pixel level);
  2. per class: 3D support + mean UNNORMALIZED logit direction;
  3. spatial mixing m[a,b] = fraction of a's k-NN neighbor slots held by b
     (k-NN over classified Gaussians, symmetrized with min);
  4. union-find merge of pairs with mixing ≥ `mix_threshold` and cosine of
     class-mean identity features ≥ `feat_threshold`, strongest mixing first.

Returns a remap vector over class ids (0 = background preserved) to apply to
rendered identity maps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ClassMergeConfig:
    """Defaults tuned on the 20-object/256²/30-frame hard scene
    (scripts/tune_class_merge.py over results/hard_scene/merge_debug.npz,
    round 5): mix 0.08 / cos 0.80 maximizes strict-1-1 (0.3979 → 0.4252,
    merging 5 class ids) at a −0.009 grouped cost; looser feature gates
    (cos < 0.8) collapse distinct objects (grouped 0.45 → 0.04 at cos −1.0),
    confirming the feature-agreement gate carries the signal."""
    k_neighbors: int = 8
    mix_threshold: float = 0.08   # min symmetric neighbor-slot fraction
    feat_threshold: float = 0.80  # cosine of class-mean identity features
    min_gaussians: int = 20       # ignore classes with tinier 3D support
    chunk: int = 2048             # kNN distance-matrix row chunk


def classify_gaussians(obj_feat: np.ndarray, code_book: np.ndarray,
                       ) -> np.ndarray:
    """Per-Gaussian class id: argmax_k code_book[k] · feat (0-based)."""
    logits = obj_feat @ code_book.T                      # [N, K]
    return logits.argmax(axis=1).astype(np.int32)


def _knn_neighbor_classes(xyz: np.ndarray, cls: np.ndarray, k: int,
                          chunk: int) -> np.ndarray:
    """[N, k] class ids of each point's k nearest OTHER points (brute-force,
    row-chunked — loop scenes hold <100k classified Gaussians)."""
    n = xyz.shape[0]
    out = np.empty((n, k), cls.dtype)
    sq = (xyz ** 2).sum(1)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = sq[s:e, None] - 2.0 * (xyz[s:e] @ xyz.T) + sq[None, :]
        d[np.arange(e - s), np.arange(s, e)] = np.inf
        idx = np.argpartition(d, k, axis=1)[:, :k]
        out[s:e] = cls[idx]
    return out


def consolidate_classes(obj_feat: np.ndarray, code_book: np.ndarray,
                        xyz: np.ndarray,
                        active: Optional[np.ndarray] = None,
                        cfg: Optional[ClassMergeConfig] = None,
                        stats: Optional[dict] = None) -> np.ndarray:
    """Merge codebook classes by 3D interleaving + identity-feature agreement.

    obj_feat [N, D] per-Gaussian identity features; code_book [K, D];
    xyz [N, 3]; active optional bool [N]. Returns remap [K + 1] over
    1-BASED rendered class ids (0 = background) — apply as ``remap[pred]``.
    """
    cfg = cfg or ClassMergeConfig()
    obj_feat = np.asarray(obj_feat, np.float32)
    code_book = np.asarray(code_book, np.float32)
    xyz = np.asarray(xyz, np.float32)
    if active is not None:
        sel = np.asarray(active, bool)
        obj_feat, xyz = obj_feat[sel], xyz[sel]
    K = code_book.shape[0]
    remap = np.arange(K + 1, dtype=np.int64)
    if len(xyz) == 0:
        return remap

    cls = classify_gaussians(obj_feat, code_book)
    counts = np.bincount(cls, minlength=K)
    big = np.flatnonzero(counts >= cfg.min_gaussians)
    if len(big) < 2:
        return remap
    keep = np.isin(cls, big)
    xyz_k, cls_k, feat_k = xyz[keep], cls[keep], obj_feat[keep]

    # class-mean identity features (the "across the clip" agreement signal:
    # identity features are optimized against EVERY view's pseudo-labels)
    fsum = np.zeros((K, obj_feat.shape[1]), np.float64)
    np.add.at(fsum, cls_k, feat_k)
    fmean = fsum / np.maximum(counts, 1)[:, None]
    norm = np.linalg.norm(fmean, axis=1, keepdims=True)
    fdir = fmean / np.maximum(norm, 1e-12)

    nbr_cls = _knn_neighbor_classes(xyz_k, cls_k,
                                    min(cfg.k_neighbors, len(xyz_k) - 1),
                                    cfg.chunk)
    # mixing[a, b] = fraction of a's neighbor slots holding class b
    pair = cls_k.repeat(nbr_cls.shape[1]).astype(np.int64) * K \
        + nbr_cls.ravel().astype(np.int64)
    mix = np.bincount(pair, minlength=K * K).reshape(K, K).astype(np.float64)
    slots = np.maximum(mix.sum(axis=1, keepdims=True), 1.0)
    mix /= slots
    sym = np.minimum(mix, mix.T)

    ii, jj = np.nonzero(np.triu(sym, 1) >= cfg.mix_threshold)
    cos = (fdir[ii] * fdir[jj]).sum(1)
    ok = cos >= cfg.feat_threshold
    if stats is not None:  # observability for threshold tuning
        tri = np.triu(sym, 1)
        stats.update(
            n_big_classes=int(len(big)),
            n_mixing_pairs=int(len(ii)),
            n_merge_pairs=int(ok.sum()),
            top_mixing=[(int(a), int(b), round(float(tri[a, b]), 3),
                         round(float((fdir[a] * fdir[b]).sum()), 3))
                        for a, b in zip(*np.unravel_index(
                            np.argsort(-tri, axis=None)[:8], tri.shape))
                        if tri[a, b] > 0],
            cos_at_mixing=[round(float(c), 3) for c in cos[:16]])
    ii, jj, strength = ii[ok], jj[ok], sym[ii, jj][ok]
    order = np.argsort(-strength)

    parent = np.arange(K)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for t in order:
        ra, rb = find(int(ii[t])), find(int(jj[t]))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    roots = np.array([find(i) for i in range(K)])
    remap[1:] = roots + 1               # rendered ids are 1-based (0 = bg)
    return remap
