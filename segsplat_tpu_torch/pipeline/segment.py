"""Per-frame instance proposals: SLIC superpixels on the device, region merge
on the host. The counterpart of segsplat_tpu/pipeline/segment.py, the
zero-external-weights stand-in for the reference's DEVA/SAM masks
(prepare_pseudo_label.sh:24-57): ids only need to be consistent regions, since
the trained codebook learns the grouping.

  1. ``slic_labels``: grid-seeded k-means in (colour, compactness·xy) space,
     each pixel competing only among the 3×3 grid cells around its own, for a
     fixed ``iters``. The JAX package scans a one-hot [H·W, K] contraction for
     the centroid update; that is 0.5 GB at 876×584 with K = 256, so the port
     sums each centroid's pixels with ``ops/voxelize.segment_sum`` (a stable
     sort and ``torch.segment_reduce``): no atomics, the same bits on every
     run. The sums are taken in another order than XLA's product, so a
     centroid may differ in its last bits and a pixel almost equidistant from
     two may change its label.
  2. ``merge_regions`` (a copy of the JAX package's numpy ``_merge_regions``):
     union-find over adjacent superpixels by mean colour, the absorption of
     regions under ``min_pixels`` and ids compacted to 1..N.

``segment_image`` runs both, the first in a ``segment.slic`` and the second in
a ``segment.merge`` span (``utils/profiling.annotate``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from segsplat_tpu_torch.ops.voxelize import segment_sum
from segsplat_tpu_torch.utils.profiling import annotate
from segsplat_tpu_torch.utils.system import require_device

# the 3×3 neighbourhood in the JAX scan's order: the first offset at the
# smallest distance wins a tie
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


@dataclasses.dataclass
class SegmentConfig:
    n_segments: int = 256        # target superpixel count (grid-rounded)
    compactness: float = 0.25    # xy weight against colour (SLIC's m / S)
    iters: int = 8
    merge_thresh: float = 0.08   # mean-colour distance under which regions merge
    min_pixels: int = 64         # smaller regions are absorbed into a neighbour


def grid_dims(h: int, w: int, n: int) -> Tuple[int, int]:
    """The seed grid (gy, gx) of about ``n`` cells with the image's aspect."""
    gy = max(int(round(np.sqrt(n * h / w))), 1)
    gx = max(int(round(n / gy)), 1)
    return gy, gx


def _centres(n: int) -> np.ndarray:
    """(arange(n) + 0.5) / n in float32, as the JAX package forms it."""
    return (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)


def slic_features(img: torch.Tensor, gy: int, gx: int, compactness: float):
    """Per-pixel features [H, W, 5] (colour, compactness·gy·y, compactness·gx·x),
    each pixel's home cell (cell_y, cell_x) [H, W] int64 and the seed
    centroids [gy·gx, 5]: the features at the seeds' pixels with their xy set
    to the exact grid seed."""
    H, W, _ = img.shape
    dev = img.device
    ys = torch.from_numpy(_centres(H)).to(dev)
    xs = torch.from_numpy(_centres(W)).to(dev)
    py = ys[:, None].expand(H, W)
    px = xs[None, :].expand(H, W)
    feat = torch.cat([img, (compactness * py * gy)[..., None],
                      (compactness * px * gx)[..., None]], dim=-1)
    seed_y = torch.from_numpy(_centres(gy)).to(dev).repeat_interleave(gx)
    seed_x = torch.from_numpy(_centres(gx)).to(dev).repeat(gy)
    iy = torch.clamp((seed_y * H).to(torch.int32), 0, H - 1).long()   # truncation
    ix = torch.clamp((seed_x * W).to(torch.int32), 0, W - 1).long()
    cent = feat[iy, ix, :].clone()
    cent[:, 3] = compactness * seed_y * gy
    cent[:, 4] = compactness * seed_x * gx
    cell_y = torch.clamp((py * gy).to(torch.int32), 0, gy - 1).long()
    cell_x = torch.clamp((px * gx).to(torch.int32), 0, gx - 1).long()
    return feat, cell_y, cell_x, cent


def slic_assign(feat: torch.Tensor, cell_y: torch.Tensor, cell_x: torch.Tensor,
                cent: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """One assignment: each pixel's nearest centroid among its 3×3 neighbour
    cells (squared distance over the 5 features), ties to the first of
    ``OFFSETS``, as the JAX scan's strict ``d < best_d`` from +inf. Returns
    labels [H, W] int64 in [0, gy·gx)."""
    k = torch.stack([torch.clamp(cell_y + dy, 0, gy - 1) * gx
                     + torch.clamp(cell_x + dx, 0, gx - 1) for dy, dx in OFFSETS])
    d = ((feat[None] - cent[k]) ** 2).sum(-1)                        # [9, H, W]
    best = torch.argmin(d, dim=0, keepdim=True)                      # the first minimum
    return torch.gather(k, 0, best)[0]


def slic_update(feat: torch.Tensor, labels: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Centroids as the mean feature of their pixels; a centroid with no pixel
    keeps its value."""
    K = cent.shape[0]
    flat = labels.reshape(-1)
    sums = segment_sum(feat.reshape(-1, feat.shape[-1]), flat, K)    # [K, 5]
    cnt = torch.bincount(flat, minlength=K).to(feat.dtype)
    return torch.where(cnt[:, None] > 0, sums / torch.clamp_min(cnt, 1.0)[:, None], cent)


def slic_labels(img: torch.Tensor, gy: int, gx: int, iters: int,
                compactness: float) -> torch.Tensor:
    """img [H, W, 3] float32 in [0, 1] → labels [H, W] int64 in [0, gy·gx), on
    img's device: ``iters`` rounds of assignment and update, returning the
    last assignment (made before the last update, as the JAX scan's labels)."""
    feat, cell_y, cell_x, cent = slic_features(img, gy, gx, compactness)
    labels = None
    for _ in range(iters):
        labels = slic_assign(feat, cell_y, cell_x, cent, gy, gx)
        cent = slic_update(feat, labels, cent)
    return labels


def merge_regions(labels: np.ndarray, image: np.ndarray,
                  cfg: SegmentConfig) -> np.ndarray:
    """Host-side agglomeration of adjacent superpixels by mean colour. The JAX
    package's ``_merge_regions`` with two of its steps done faster and to the
    same bits: the colour sums by ``np.bincount`` (float64, in pixel order, as
    ``np.add.at``), and the adjacent pairs as unique 1-D keys lo·K + hi (the
    same lexicographic order as ``np.unique(..., axis=1)``, which sorts
    structured rows)."""
    K = int(labels.max()) + 1
    flat = labels.reshape(-1)
    cols = image.reshape(-1, 3)
    sums = np.stack([np.bincount(flat, weights=cols[:, c], minlength=K)
                     for c in range(3)], axis=1)
    cnt = np.bincount(flat, minlength=K).astype(np.float64)
    mean = sums / np.maximum(cnt, 1.0)[:, None]

    # adjacency from horizontal/vertical label transitions
    pairs = set()
    for a, b in ((labels[:, :-1], labels[:, 1:]),
                 (labels[:-1, :], labels[1:, :])):
        lo = np.minimum(a, b).reshape(-1).astype(np.int64)
        hi = np.maximum(a, b).reshape(-1).astype(np.int64)
        keys = np.unique(lo * K + hi)
        for u, v in zip(keys // K, keys % K):
            if u != v:
                pairs.add((int(u), int(v)))

    parent = np.arange(K)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(ru, rv):
        # pool colour means so later merge decisions see the merged region
        tot = cnt[ru] + cnt[rv]
        mean[ru] = (mean[ru] * cnt[ru] + mean[rv] * cnt[rv]) / max(tot, 1)
        cnt[ru] = tot
        parent[rv] = ru

    # merge similar neighbours (smallest colour gap first — stable greedy)
    edges = sorted(pairs, key=lambda e: np.sum((mean[e[0]] - mean[e[1]]) ** 2))
    for u, v in edges:
        ru, rv = find(u), find(v)
        if ru != rv and np.sqrt(np.sum((mean[ru] - mean[rv]) ** 2)) \
                < cfg.merge_thresh:
            union(ru, rv)

    roots = np.array([find(i) for i in range(K)])
    merged = roots[labels]

    # absorb tiny regions into their most-similar neighbour; two merged small
    # regions can still be under min_pixels, so track the pooled size (cnt
    # follows roots through union) and loop until no sub-threshold region
    # has an edge left to absorb along
    sizes = np.bincount(merged.reshape(-1), minlength=K)
    small = set(np.nonzero((sizes > 0) & (sizes < cfg.min_pixels))[0].tolist())
    changed = bool(small)
    while changed and small:
        changed = False
        for u, v in edges:
            ru, rv = find(u), find(v)
            if ru != rv and (ru in small or rv in small):
                union(ru, rv)
                small.discard(rv)                # rv is no longer a root
                if cnt[ru] >= cfg.min_pixels:
                    small.discard(ru)
                else:
                    small.add(ru)
                changed = True
    roots = np.array([find(i) for i in range(K)])
    merged = roots[labels]

    # compact to 1..N (0 reserved for background by convention)
    uniq = np.unique(merged)
    remap = np.zeros(K, np.int32)
    remap[uniq] = np.arange(1, len(uniq) + 1, dtype=np.int32)
    return remap[merged]


def segment_image(image: np.ndarray, cfg: SegmentConfig = SegmentConfig(),
                  device: str | torch.device = "cuda") -> np.ndarray:
    """[H, W, 3] uint8 or float image → [H, W] int32 instance-id map, ids from
    1 (no background class: the tracker and the trainer treat every region as
    an instance, like the reference's DEVA id maps). SLIC runs on ``device``
    (the card unless the caller asks for the CPU)."""
    device = require_device(device)
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    H, W = img.shape[:2]
    gy, gx = grid_dims(H, W, cfg.n_segments)
    with annotate("segment.slic"):
        labels = slic_labels(torch.as_tensor(img, dtype=torch.float32, device=device),
                             gy, gx, cfg.iters, cfg.compactness).cpu().numpy()
    with annotate("segment.merge"):
        return merge_regions(labels, img, cfg)
