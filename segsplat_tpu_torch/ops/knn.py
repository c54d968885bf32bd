"""Mean squared distance to the k nearest neighbours — the reference's
simple-knn distCUDA2, which seeds the initial Gaussian scales
(scene/gaussian_model.py:150).

The counterpart of segsplat_tpu/ops/knn.py, with its algorithm kept: Morton-sort
the points (10 bits per axis, a STABLE sort as jnp.argsort is: at 10 bits ties
are common, and another order changes the boxes) into 16-point boxes with
AABBs, rank every box by point-to-AABB distance for each query, keep the 32
closest (ties to the lower box index, as lax.top_k keeps them) and brute-force
their 512 candidates. Torch ops on the points' device, chunked over queries.

Also the exact 1-NN index of the query stage (``nearest_neighbor_index``).
"""

from __future__ import annotations

import numpy as np
import torch

_MORTON_BITS = 10


def _expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Interleave two zeros between the low 10 bits (30-bit Morton spread)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """[N, 3] float32 → [N] int64 Morton codes over the bounding box."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    # a true division: `scalar / tensor` in torch multiplies by the reciprocal,
    # which rounds twice and moves a few points to the next cell
    scale = torch.div(torch.full_like(lo, 2.0 ** _MORTON_BITS - 1),
                      torch.clamp_min(hi - lo, 1e-12))
    q = torch.clamp((points - lo) * scale, 0, 2.0 ** _MORTON_BITS - 1).to(torch.int64)
    return (_expand_bits10(q[:, 0]) | (_expand_bits10(q[:, 1]) << 1)
            | (_expand_bits10(q[:, 2]) << 2))


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3, box: int = 16,
                     m_boxes: int = 32, chunk: int = 1024) -> torch.Tensor:
    """Mean squared distance [N] float32 to the k nearest neighbours of each
    point (distCUDA2's boxMeanDist), on the points' device."""
    n = points.shape[0]
    dev = points.device
    order = torch.sort(morton_codes(points), stable=True).indices
    sp = points[order]                                        # [N, 3] sorted

    pad = (-n) % box
    spp = torch.cat([sp, torch.full((pad, 3), float("inf"), dtype=sp.dtype, device=dev)])
    nb = spp.shape[0] // box
    boxed = spp.reshape(nb, box, 3)
    finite = torch.isfinite(boxed)
    bmin = torch.where(finite, boxed, float("inf")).amin(dim=1)
    bmax = torch.where(finite, boxed, float("-inf")).amax(dim=1)
    m = min(m_boxes, nb)
    slot = torch.arange(box, device=dev)

    out = torch.empty((n,), dtype=points.dtype, device=dev)
    for q0 in range(0, n, chunk):
        q = sp[q0:q0 + chunk]                                 # [B, 3]
        r = torch.arange(q0, q0 + q.shape[0], device=dev)
        d = torch.clamp_min(torch.maximum(bmin[None] - q[:, None], q[:, None] - bmax[None]),
                            0.0)
        bd2 = (d * d).sum(-1)                                 # [B, nb]
        top = torch.sort(bd2, dim=1, stable=True).indices[:, :m]   # closest boxes
        cidx = (top[:, :, None] * box + slot[None, None, :]).reshape(q.shape[0], -1)
        valid = (cidx < n) & (cidx != r[:, None])             # drop padding + self
        nbrs = sp[torch.clamp(cidx, 0, n - 1)]                # [B, m·box, 3]
        d2 = ((nbrs - q[:, None, :]) ** 2).sum(-1)
        d2 = torch.where(valid, d2, float("inf"))
        total = torch.zeros((q.shape[0],), dtype=points.dtype, device=dev)
        rows = torch.arange(q.shape[0], device=dev)
        for _ in range(k):                                    # k successive minima
            total = total + d2.amin(dim=1)
            d2[rows, d2.argmin(dim=1)] = float("inf")
        out[q0:q0 + q.shape[0]] = total / k
    result = torch.empty_like(out)
    result[order] = out
    return result


def initial_log_scales(points: np.ndarray, device="cuda") -> torch.Tensor:
    """log(sqrt(clamp(dist2, 1e-7))) replicated ×3 — the Gaussian scale init
    (scene/gaussian_model.py:150-151), on ``device``."""
    d2 = knn_mean_sq_dist(torch.as_tensor(np.asarray(points, np.float32), device=device))
    s = torch.log(torch.sqrt(torch.clamp_min(d2, 1e-7)))
    return s[:, None].repeat(1, 3)


def nearest_neighbor_index(queries: torch.Tensor, refs: torch.Tensor,
                           chunk: int = 4096) -> torch.Tensor:
    """Exact 1-NN index of each query among refs, the Gaussian→voxel map of
    pipeline/query.build_map (the reference's voxeltoGaussian_logits.py:86-105
    uses a CPU KD-tree). Keeps the JAX package's arithmetic: per chunk of
    queries, d = -2·(q @ refsᵀ) + |r|² with |q|² dropped, and the first index
    of the least d, as ``jnp.argmin`` takes it. Two refs whose squared
    distances lie within the products' rounding (about eps₃₂·(|q|² + |r|²)) may
    be told apart otherwise than by the JAX package.

    queries [M, 3], refs [V, 3] on one device → [M] int64 on that device; one
    [chunk, V] float32 temporary at a time.
    """
    r2 = (refs * refs).sum(dim=1)                              # [V]
    out = torch.empty((queries.shape[0],), dtype=torch.int64, device=queries.device)
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0:q0 + chunk]
        d = torch.addmm(r2, q, refs.T, alpha=-2.0)               # [chunk, V]
        out[q0:q0 + q.shape[0]] = torch.argmin(d, dim=1)
        del d
    return out
