"""DEVA-lite temporal instance-id association (pseudo-label tracking): the
port's copy of segsplat_tpu/pipeline/tracking.py, numpy on the host in both
packages. Only the matching solver differs: the JAX package solves the padded
1 − IoU cost with its on-device Hungarian, the port with its host
Jonker–Volgenant (ops/assignment.py), which has the same tie rule, so the id
maps are the same.

The reference vendors Tracking-Anything-with-DEVA (~11.4k LoC) and drives it
twice per scene (script/debug_checks_scripts/prepare_pseudo_label.sh:24-57) to
turn per-frame instance segmentations into the temporally-consistent
``object_mask/`` id maps Unified-Lift trains on (dataset_readers.py:105-106).

This module rebuilds the association core without the vendored tracker:
per-frame instance masks with ARBITRARY ids are linked across time by
maximum-IoU bipartite matching — solved with the port's host solver
(ops/assignment.linear_sum_assignment, the one the training loop uses for
virtual-GT matching) — plus a short-term mask memory
that bridges occlusions/dropouts of up to ``memory_frames`` frames.

It does not re-segment (DEVA's in-clip consensus); feed it per-frame masks
from any segmenter (SAM exports, color masks via
scripts/prepare_pseudo_label.py convert, etc.).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from segsplat_tpu_torch.ops.assignment import linear_sum_assignment


@dataclasses.dataclass
class TrackerConfig:
    iou_threshold: float = 0.3     # min IoU to link an instance to a track
    memory_frames: int = 30        # how long a lost track stays matchable
    min_pixels: int = 16           # ignore smaller instances
    max_ids: int = 255             # id budget (id 0 = background)
    motion: bool = True            # constant-velocity mask shift before IoU
    color_gate: float = 0.0        # mean-RGB distance above which a link is
    #                                vetoed (0 disables; needs images). DEVA
    #                                matches in a learned appearance space;
    #                                this is the classical stand-in: on an
    #                                orbit sweep small objects move farther
    #                                than their own extent per frame, so raw
    #                                IoU both fragments them AND relinks
    #                                reappearing tracks to whatever overlaps.
    centroid_fallback_frac: float = 0.0
    #   second-pass match of IoU-unmatched instances to unmatched live
    #   tracks by centroid distance ≤ frac·√area (color-gated when images
    #   are given; 0 disables). Bootstraps the velocity estimate for movers
    #   whose consecutive-frame IoU never clears the threshold.


def extract_instances(id_map: np.ndarray, min_pixels: int = 1
                      ) -> List[np.ndarray]:
    """[H, W] integer map (0 = background) → list of boolean instance masks."""
    out = []
    for v in np.unique(id_map):
        if v == 0:
            continue
        m = id_map == v
        if int(m.sum()) >= min_pixels:
            out.append(m)
    return out


def _iou_matrix(prev: Sequence[np.ndarray], cur: Sequence[np.ndarray]
                ) -> np.ndarray:
    """[P, C] IoU between stored track masks and current instances.

    Current-frame instances are disjoint regions of one id map (that's how
    extract_instances produces them), so they are painted into a single
    int map once and each track's intersections with ALL instances come from
    one bincount over its masked pixels — no [P, HW]×[C, HW] float stacking
    (which cost hundreds of MB per frame at 1752×1168 with ~50 live tracks).
    If a caller passes overlapping instance masks, later masks win the
    overlapped pixels."""
    if not prev or not cur:
        return np.zeros((len(prev), len(cur)), np.float32)
    cur_map = np.zeros(cur[0].shape, np.int32)                   # 0 = none
    areas_c = np.empty(len(cur), np.int64)
    for j, m in enumerate(cur):
        cur_map[m] = j + 1
        areas_c[j] = int(m.sum())
    iou = np.zeros((len(prev), len(cur)), np.float32)
    for i, pm in enumerate(prev):
        inter = np.bincount(cur_map[pm], minlength=len(cur) + 1)[1:]
        union = int(pm.sum()) + areas_c - inter
        iou[i] = np.where(union > 0,
                          inter / np.maximum(union, 1), 0.0)
    return iou


def _match(iou: np.ndarray, threshold: float) -> Dict[int, int]:
    """Maximum-IoU bipartite matching → {cur_index: prev_index}; pairs under
    ``threshold`` stay unmatched. Solved on the host by ops/assignment."""
    p, c = iou.shape
    if p == 0 or c == 0:
        return {}
    n = max(p, c)
    cost = np.ones((n, n), np.float32)          # cost = 1 - IoU, padded
    cost[:p, :c] = 1.0 - iou
    col_of_row, _ = linear_sum_assignment(cost)
    out = {}
    for pi in range(p):
        ci = int(col_of_row[pi])
        if ci < c and iou[pi, ci] >= threshold:
            out[ci] = pi
    return out


def _shift_mask(mask: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Integer-pixel mask translation with zero fill (no wraparound)."""
    if dy == 0 and dx == 0:
        return mask
    out = np.zeros_like(mask)
    h, w = mask.shape
    if abs(dy) >= h or abs(dx) >= w:
        return out
    sy0, sy1 = max(0, -dy), min(h, h - dy)
    sx0, sx1 = max(0, -dx), min(w, w - dx)
    out[sy0 + dy:sy1 + dy, sx0 + dx:sx1 + dx] = mask[sy0:sy1, sx0:sx1]
    return out


def _centroid(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    return np.array([ys.mean(), xs.mean()])


class InstanceTracker:
    """Streaming tracker: feed per-frame instance masks, get stable ids.

    With ``cfg.motion`` each track's stored mask is translated by its
    constant-velocity prediction (per-frame centroid velocity × frames since
    last seen) before IoU — DEVA propagates masks with a network; the
    translation is the classical equivalent that keeps small fast-moving
    instances matchable on orbit sweeps. With ``cfg.color_gate`` > 0 and an
    RGB ``image`` passed to update(), a link whose track/instance mean-color
    distance exceeds the gate is vetoed (appearance memory across
    occlusions)."""

    def __init__(self, cfg: TrackerConfig = TrackerConfig()):
        self.cfg = cfg
        self.track_masks: List[np.ndarray] = []    # last-seen mask per track
        self.track_last_seen: List[int] = []
        self.track_centroid: List[np.ndarray] = []
        self.track_vel: List[np.ndarray] = []      # px/frame, (dy, dx)
        self.track_color: List[np.ndarray] = []    # EMA mean RGB in [0,1]
        self.next_id = 1
        self.frame = -1

    @staticmethod
    def _mean_color(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        img = image.astype(np.float32)
        if image.dtype == np.uint8:
            img = img / 255.0
        return img[mask].mean(axis=0)

    def update(self, instances: Sequence[np.ndarray],
               image: np.ndarray | None = None) -> List[int]:
        """Associate this frame's instance masks; returns their global ids
        (order-aligned with ``instances``)."""
        self.frame += 1
        live = [i for i, last in enumerate(self.track_last_seen)
                if self.frame - last <= self.cfg.memory_frames]
        # expired tracks can never match again — free their full-res masks
        # (up to max_ids × H×W bools ≈ 0.5 GB at reference resolution)
        live_set = set(live)
        for i, mask in enumerate(self.track_masks):
            if mask is not None and i not in live_set:
                self.track_masks[i] = None
        prev = []
        for i in live:
            m = self.track_masks[i]
            if self.cfg.motion:
                gap = self.frame - self.track_last_seen[i]
                d = np.rint(self.track_vel[i] * gap).astype(int)
                m = _shift_mask(m, int(d[0]), int(d[1]))
            prev.append(m)
        iou = _iou_matrix(prev, instances)
        inst_col = (np.stack([self._mean_color(image, m) for m in instances])
                    if (image is not None and len(instances)) else None)
        if self.cfg.color_gate > 0 and inst_col is not None and len(live):
            trk_col = np.stack([self.track_color[i] for i in live])
            dist = np.linalg.norm(trk_col[:, None] - inst_col[None], axis=2)
            iou = np.where(dist > self.cfg.color_gate, 0.0, iou)
        match = _match(iou, self.cfg.iou_threshold)
        if self.cfg.centroid_fallback_frac > 0 and len(live):
            self._centroid_fallback(match, iou, live, instances, inst_col)
        ids = []
        updated_this_frame: set = set()
        for ci, mask in enumerate(instances):
            cen = _centroid(mask)
            if ci in match:
                ti = live[match[ci]]
                gap = max(self.frame - self.track_last_seen[ti], 1)
                self.track_vel[ti] = (cen - self.track_centroid[ti]) / gap
                if image is not None:
                    self.track_color[ti] = (0.8 * self.track_color[ti]
                                            + 0.2 * inst_col[ci])
            elif self.next_id > self.cfg.max_ids:
                # id budget exhausted: dropping to background LOSES the
                # pixels for training (measured 21% of foreground on the
                # 20-object hard scene) — merge into the best live track
                # instead: highest surviving (gated) IoU, else the nearest
                # color-compatible centroid
                ti = self._budget_fallback(iou, ci, live, cen, inst_col)
                if ti is None:
                    ids.append(0)
                    continue
            else:
                ti = len(self.track_masks)
                self.track_masks.append(mask)
                self.track_last_seen.append(self.frame)
                self.track_centroid.append(cen)
                self.track_vel.append(np.zeros(2))
                self.track_color.append(
                    inst_col[ci] if inst_col is not None else np.zeros(3))
                self.next_id += 1
            if ti in updated_this_frame:
                # several fragments landed on one track this frame: the
                # track is their union, not the last fragment
                mask = mask | self.track_masks[ti]
                cen = _centroid(mask)
            self.track_masks[ti] = mask
            self.track_last_seen[ti] = self.frame
            self.track_centroid[ti] = cen
            updated_this_frame.add(ti)
            ids.append(ti + 1)
        return ids

    def _centroid_fallback(self, match: Dict[int, int], iou: np.ndarray,
                           live: List[int], instances, inst_col) -> None:
        """Second-pass association by centroid distance (mutates ``match``):
        IoU-unmatched instances greedily take the nearest unmatched live
        track within ``centroid_fallback_frac``·√area, color-compatible when
        colors are known. Greedy nearest-first (not Hungarian) — the pass
        exists to bootstrap velocity for movers, not to contest clear
        matches."""
        taken = set(match.values())
        free_t = [k for k in range(len(live)) if k not in taken]
        free_i = [ci for ci in range(len(instances)) if ci not in match]
        if not free_t or not free_i:
            return
        pairs = []
        for ci in free_i:
            cen = _centroid(instances[ci])
            rad = self.cfg.centroid_fallback_frac * np.sqrt(
                float(instances[ci].sum()))
            for k in free_t:
                ti = live[k]
                gap = max(self.frame - self.track_last_seen[ti], 1)
                pred = self.track_centroid[ti] + self.track_vel[ti] * gap
                d = float(np.linalg.norm(pred - cen))
                if d > rad:
                    continue
                if (inst_col is not None and self.cfg.color_gate > 0
                        and np.linalg.norm(self.track_color[ti]
                                           - inst_col[ci])
                        > self.cfg.color_gate):
                    continue
                pairs.append((d, ci, k))
        for _, ci, k in sorted(pairs, key=lambda p: p[0]):
            if ci in match or k in taken:
                continue
            match[ci] = k
            taken.add(k)

    def _budget_fallback(self, iou: np.ndarray, ci: int, live: List[int],
                         cen: np.ndarray, inst_col):
        """Best live track for an instance the id budget cannot open a new
        track for; None only when no live track is compatible."""
        if not live:
            return None
        col = iou[:, ci]
        best = int(np.argmax(col))
        if col[best] > 0:
            return live[best]
        order = np.argsort([np.linalg.norm(self.track_centroid[i] - cen)
                            for i in live])
        for k in order:
            i = live[k]
            if (inst_col is None or self.cfg.color_gate <= 0
                    or np.linalg.norm(self.track_color[i] - inst_col[ci])
                    <= self.cfg.color_gate):
                return i
        return None


@dataclasses.dataclass
class ConsolidateConfig:
    min_cooccur: int = 3        # frames both tracks must co-appear in
    adjacency_frac: float = 0.5  # fraction of co-occurring frames touching
    boundary_min: int = 8        # shared-boundary px for "touching"
    color_thresh: float = 0.10   # pooled mean-color gate (needs images)


def consolidate_tracks(id_maps: Sequence[np.ndarray],
                       images: Sequence[np.ndarray] | None = None,
                       cfg: ConsolidateConfig = ConsolidateConfig()
                       ) -> List[np.ndarray]:
    """DEVA-style in-clip consensus: merge region-level tracks into
    object-level ids using whole-sweep evidence.

    The reference's DEVA merges per-frame segments into objects by
    propagating and voting masks across the clip (in-clip consensus,
    Tracking-Anything-with-DEVA); our SLIC proposals instead split one
    object into several superpixel-level tracks, which the strict 1-1
    identity protocol punishes. This pass fuses tracks that the whole
    sweep says are one object: a pair merges when it co-occurs in
    ≥``min_cooccur`` frames, shares a ≥``boundary_min``-px boundary in
    ≥``adjacency_frac`` of those frames, and (when ``images`` are given)
    has pooled mean colors within ``color_thresh``. Merging is union-find
    with color pooling, strongest adjacency evidence first, so transitive
    chains still respect the color gate.

    ``id_maps`` are temporally-consistent maps from associate_sequence
    (0 = background). Returns new maps with ids compacted to 1..N.
    """
    id_maps = [np.asarray(m) for m in id_maps]
    n = int(max((m.max() for m in id_maps), default=0))
    if n == 0:
        return [m.copy() for m in id_maps]
    F = len(id_maps)
    present = np.zeros((F, n + 1), bool)
    adj = np.zeros((n + 1, n + 1), np.int64)      # frames with contact
    csum = np.zeros((n + 1, 3), np.float64)
    ccnt = np.zeros(n + 1, np.float64)
    for f, m in enumerate(id_maps):
        present[f, np.unique(m)] = True
        # shared-boundary length between distinct nonzero ids, 4-neighborhood
        keys = []
        for a, b in ((m[:, :-1], m[:, 1:]), (m[:-1, :], m[1:, :])):
            lo = np.minimum(a, b).ravel()
            hi = np.maximum(a, b).ravel()
            sel = (lo > 0) & (lo != hi)
            keys.append(lo[sel].astype(np.int64) * (n + 1) + hi[sel])
        pair_keys, counts = np.unique(np.concatenate(keys),
                                      return_counts=True)
        strong = pair_keys[counts >= cfg.boundary_min]
        adj[strong // (n + 1), strong % (n + 1)] += 1
        if images is not None:
            img = np.asarray(images[f])
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            flat = m.ravel()
            np.add.at(csum, flat, img.reshape(-1, 3))
            ccnt += np.bincount(flat, minlength=n + 1)
    present[:, 0] = False
    cooccur = present.astype(np.int64).T @ present.astype(np.int64)
    mean = csum / np.maximum(ccnt, 1.0)[:, None]

    ii, jj = np.nonzero((cooccur >= cfg.min_cooccur)
                        & (adj / np.maximum(cooccur, 1) >= cfg.adjacency_frac))
    frac = (adj / np.maximum(cooccur, 1))[ii, jj]
    order = np.argsort(-frac)

    parent = np.arange(n + 1)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for k in order:
        ra, rb = find(int(ii[k])), find(int(jj[k]))
        if ra == rb:
            continue
        if images is not None:
            d = float(np.sqrt(np.sum((mean[ra] - mean[rb]) ** 2)))
            if d >= cfg.color_thresh:
                continue
            tot = ccnt[ra] + ccnt[rb]
            mean[ra] = (mean[ra] * ccnt[ra] + mean[rb] * ccnt[rb]) \
                / max(tot, 1.0)
            ccnt[ra] = tot
        parent[rb] = ra

    roots = np.array([find(i) for i in range(n + 1)])
    uniq = np.unique(roots[1:])
    remap = np.zeros(n + 1, np.int64)
    remap[uniq] = np.arange(1, len(uniq) + 1)
    remap = remap[roots]                         # id → compacted merged id
    remap[0] = 0
    n_out = int(remap.max())
    dtype = np.uint8 if n_out <= 255 else np.uint16
    return [remap[m].astype(dtype) for m in id_maps]


def associate_sequence(frames: Iterable[np.ndarray],
                       cfg: TrackerConfig = TrackerConfig(),
                       images: Sequence[np.ndarray] | None = None
                       ) -> List[np.ndarray]:
    """Per-frame id maps (arbitrary per-frame ids) → temporally-consistent id
    maps. Later instances win overlapping pixels (matches DEVA's painting
    order for its id masks). ``images`` (RGB, frame-aligned) enable the
    appearance gate when cfg.color_gate > 0."""
    tracker = InstanceTracker(cfg)
    out = []
    for fi, frame in enumerate(frames):
        inst = extract_instances(np.asarray(frame), cfg.min_pixels)
        ids = tracker.update(
            inst, image=None if images is None else np.asarray(images[fi]))
        # canvas dtype follows the id budget: uint8 would alias ids mod 256
        # if a user raises max_ids past 255
        dtype = np.uint8 if cfg.max_ids <= 255 else np.uint16
        canvas = np.zeros(np.asarray(frame).shape, dtype)
        for mask, gid in zip(inst, ids):
            canvas[mask] = gid
        out.append(canvas)
    return out
