"""The pseudo-label quality loop, the port's twin of
scripts/pseudo_label_loop.py (same flags, same JSON result keys): does
Unified-Lift training on the in-framework SLIC + track pseudo-labels converge
to clean instance identities?

    python -m segsplat_tpu_torch.pseudo_label_loop [--frames 36] [--size 128] [--device cuda|cpu]

  1. a synthetic multi-object Gaussian scene (coloured blobs with known
     per-Gaussian object ids, the JAX script's seeded builder) rendered on an
     orbit through ``ops/rasterize.rasterize`` at 3 + n_objects channels (RGB
     and one one-hot channel per object) → RGB frames and GT instance maps;
  2. a COLMAP-layout dataset of it, then ``prepare_pseudo_label``'s segment
     and track stages → ``object_mask/``;
  3. the tracker's temporal consistency against the GT maps;
  4. Unified-Lift training on the pseudo-labels (``pipeline/train.train``),
     16-channel identity renders per view classified by the trained codebook,
     predicted classes matched to the GT objects (grouped by IoA and strict
     1-1 by the host Jonker–Volgenant), the LERF-Masked protocol on the
     trained scene, and the class consolidation re-scored.

On ``device="cuda"`` (the default) every render goes through the kernels (K1
forward, K2 in training); ``device="cpu"`` takes the dense backend, as the
JAX script takes ``"xla"`` on the CPU.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from segsplat_tpu_torch.core.transforms import fov2focal, rotmat2qvec
from segsplat_tpu_torch.core.types import Camera
from segsplat_tpu_torch.eval.metrics import boundary_iou, mask_iou
from segsplat_tpu_torch.io.colmap import (ColmapCamera, ColmapImage, write_extrinsics_binary,
                                          write_intrinsics_binary, write_points3D_binary)
from segsplat_tpu_torch.ops.assignment import linear_sum_assignment
from segsplat_tpu_torch.ops.rasterize import rasterize
from segsplat_tpu_torch.pipeline.consolidate import consolidate_classes
from segsplat_tpu_torch.pipeline.query import LERF_NEGATIVES, text_query_mask
from segsplat_tpu_torch.pipeline.train import TrainRunConfig, train
from segsplat_tpu_torch.prepare_pseudo_label import segment_images, track_sequence
from segsplat_tpu_torch.render import raster_backend, render
from segsplat_tpu_torch.train.editing import select_obj_ioa
from segsplat_tpu_torch.train.trainer import OptimizationConfig
from segsplat_tpu_torch.utils.system import require_device

N_OBJECTS = 5


# ───────────────────────── scene + GT sweep ─────────────────────────

def _hsv_colors(n: int, rng) -> np.ndarray:
    """n distinct-ish base colors on the HSV wheel; at n ≥ 15 hues crowd
    (neighboring objects within ~0.05 hue) — intentional difficulty."""
    import colorsys
    hues = (np.arange(n) / n + rng.uniform(0, 1)) % 1.0
    sat = rng.uniform(0.55, 0.95, n)
    val = rng.uniform(0.55, 0.95, n)
    return np.array([colorsys.hsv_to_rgb(h, s, v)
                     for h, s, v in zip(hues, sat, val)], np.float32)


def build_objects(rng, per_obj: int = 200, n_objects: int = N_OBJECTS,
                  layout: str = "fixed", textured: bool = False):
    """K colored Gaussian blobs around the origin; returns dict of arrays
    incl. per-Gaussian GT object id (1-based; 0 = background).

    layout='fixed' keeps the round-3 well-separated 5-object scene;
    layout='random' packs ``n_objects`` into a 0.9-radius ball with only a
    0.28 min-separation — on the orbit, objects routinely occlude each
    other. textured=True gives each object a two-tone plane-wave surface
    texture (intra-object gradients SLIC oversegments on) instead of a flat
    albedo — the realistic-difficulty axis of VERDICT r3 #5."""
    if layout == "fixed" and n_objects <= 5:
        centers = np.array([[0.6, 0.0, 0.0], [-0.5, 0.35, 0.2],
                            [0.0, -0.55, -0.3], [-0.1, 0.5, -0.45],
                            [0.15, -0.1, 0.55]])[:n_objects]
        base_colors = np.array([[0.9, 0.15, 0.1], [0.1, 0.8, 0.2],
                                [0.15, 0.25, 0.9], [0.9, 0.8, 0.1],
                                [0.8, 0.15, 0.85]])[:n_objects]
    else:
        centers = []
        while len(centers) < n_objects:
            c = rng.uniform(-0.9, 0.9, 3)
            if np.linalg.norm(c) > 0.95:
                continue
            if centers and np.min(np.linalg.norm(
                    np.asarray(centers) - c, axis=1)) < 0.28:
                continue
            centers.append(c)
        centers = np.asarray(centers, np.float32)
        base_colors = _hsv_colors(n_objects, rng)
    xyz, rgb, oid = [], [], []
    for k in range(n_objects):
        spread = 0.16 if layout == "fixed" else float(rng.uniform(0.10, 0.19))
        pts = centers[k] + rng.normal(0, spread, (per_obj, 3))
        if textured:
            # two-tone plane-wave texture across the object's extent
            c2 = np.clip(base_colors[k][::-1] * rng.uniform(0.4, 1.0), 0, 1)
            d = rng.standard_normal(3)
            d /= np.linalg.norm(d)
            freq = rng.uniform(6.0, 14.0)
            w = 0.5 + 0.5 * np.sin(freq * (pts - centers[k]) @ d
                                   + rng.uniform(0, 2 * np.pi))
            col = (w[:, None] * base_colors[k] + (1 - w[:, None]) * c2)
            col = np.clip(col + rng.normal(0, 0.02, (per_obj, 3)), 0, 1)
        else:
            col = np.clip(base_colors[k] + rng.normal(0, 0.03, (per_obj, 3)),
                          0, 1)
        xyz.append(pts)
        rgb.append(col)
        oid.append(np.full(per_obj, k + 1))
    n = n_objects * per_obj
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return dict(
        xyz=np.concatenate(xyz).astype(np.float32),
        rgb=np.concatenate(rgb).astype(np.float32),
        oid=np.concatenate(oid).astype(np.int32),
        scales=np.exp(rng.normal(-3.6, 0.15, (n, 3))).astype(np.float32),
        quats=quats,
        opac=rng.uniform(0.88, 0.99, n).astype(np.float32))


def orbit_cameras(F: int, H: int, W: int, radius: float = 3.0, fov: float = 0.9):
    """F inward-looking w2c poses on a tilted orbit; returns (Rwc, tvec) lists
    plus fx/fy."""
    Rs, ts = [], []
    for i in range(F):
        ang = 2 * np.pi * i / F
        pos = np.array([radius * np.sin(ang), 0.6 * np.sin(2 * ang),
                        -radius * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        Rwc = np.stack([right, up, fwd], axis=0)   # rows = cam axes → w2c
        Rs.append(Rwc)
        ts.append(-Rwc @ pos)
    fx = fov2focal(fov, W)
    return Rs, ts, fx, fx


def _camera(Rwc, t, fx, fy, H, W, device) -> Camera:
    f32 = dict(dtype=torch.float32, device=device)
    return Camera(R=torch.as_tensor(np.asarray(Rwc.T, np.float32), **f32),
                  T=torch.as_tensor(np.asarray(t, np.float32), **f32),
                  fov_x=torch.tensor(2 * np.arctan(W / (2 * fx)), **f32),
                  fov_y=torch.tensor(2 * np.arctan(H / (2 * fy)), **f32),
                  width=W, height=H)


def render_sweep(g, Rs, ts, fx, fy, H, W, max_per_tile=512, device="cuda"):
    """RGB frames + GT instance-id maps from the rasterizer at 3 + n_objects
    channels (one-hot object channels; alpha < 0.5 → background 0)."""
    device = require_device(device)
    n_obj = int(g["oid"].max())
    onehot = np.zeros((len(g["oid"]), n_obj), np.float32)
    onehot[np.arange(len(g["oid"])), g["oid"] - 1] = 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    payload = t(np.concatenate([g["rgb"], onehot], axis=1))
    kw = dict(width=W, height=H, max_tiles_per_axis=6, max_per_tile=max_per_tile,
              backend=raster_backend(device), tile_chunk=16)
    rgbs, gts = [], []
    with torch.no_grad():
        for Rwc, tv in zip(Rs, ts):
            cam = _camera(Rwc, tv, fx, fy, H, W, device)
            out = rasterize(t(g["xyz"]), t(g["scales"]), t(g["quats"]), t(g["opac"]),
                            payload, cam.world_view_transform(), fx, fy, W / 2, H / 2,
                            bg=torch.zeros(3 + n_obj, device=device), **kw)
            img = out["image"].cpu().numpy()
            alpha = out["alpha"].cpu().numpy()
            rgbs.append(np.clip(img[..., :3], 0, 1))
            gt = np.argmax(img[..., 3:], axis=-1) + 1
            gt[alpha < 0.5] = 0
            gts.append(gt.astype(np.int32))
    return np.stack(rgbs), np.stack(gts)


def write_colmap_scene(root, g, Rs, ts, fx, fy, rgbs):
    """COLMAP-layout dataset (sparse/0 + images/) via io/colmap writers."""
    F, H, W = rgbs.shape[:3]
    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    cams = {1: ColmapCamera(id=1, model="PINHOLE", width=W, height=H,
                            params=np.array([fx, fy, W / 2, H / 2]))}
    images = {}
    for i, (Rwc, t) in enumerate(zip(Rs, ts)):
        name = f"frame_{i:03d}.png"
        Image.fromarray((rgbs[i] * 255).astype(np.uint8)).save(
            os.path.join(root, "images", name))
        images[i + 1] = ColmapImage(
            id=i + 1, qvec=rotmat2qvec(Rwc), tvec=np.asarray(t), camera_id=1,
            name=name, xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))
    write_intrinsics_binary(os.path.join(root, "sparse", "0", "cameras.bin"), cams)
    write_extrinsics_binary(os.path.join(root, "sparse", "0", "images.bin"), images)
    # init point cloud: all GT centers with their colors
    sel = np.arange(len(g["xyz"]))
    write_points3D_binary(os.path.join(root, "sparse", "0", "points3D.bin"),
                          g["xyz"][sel], (g["rgb"][sel] * 255).astype(np.uint8))


# ───────────────────────── metrics ─────────────────────────

def tracker_consistency(tracked, gts):
    """Temporal id-consistency: for each track, its majority GT object across
    the sweep; score = pixel-weighted fraction of (frame, track) masses whose
    per-frame majority GT object equals the track's global majority. 1.0 =
    every track means the same GT object in every frame it appears."""
    F = len(tracked)
    n_tracks = int(max(t.max() for t in tracked))
    votes = {}                       # track → {gt_obj: pixels}
    frame_major = []                 # per frame: track → (majority gt, pixels)
    for f in range(F):
        tr, gt = tracked[f], gts[f]
        fm = {}
        for tid in np.unique(tr):
            if tid == 0:
                continue
            sel = tr == tid
            lab, cnt = np.unique(gt[sel], return_counts=True)
            maj = int(lab[cnt.argmax()])
            fm[int(tid)] = (maj, int(sel.sum()))
            votes.setdefault(int(tid), {})
            votes[int(tid)][maj] = votes[int(tid)].get(maj, 0) + int(sel.sum())
        frame_major.append(fm)
    global_major = {tid: max(v, key=v.get) for tid, v in votes.items()}
    agree = total = 0
    for fm in frame_major:
        for tid, (maj, px) in fm.items():
            total += px
            if maj == global_major[tid]:
                agree += px
    return (agree / max(total, 1)), n_tracks


def match_miou(pred, gts, n_pred_classes, n_objects: int = N_OBJECTS):
    """Match predicted class ids to GT objects (background 0 included) and
    report per-object IoU: grouped (every predicted class whose IoA with the
    object > 0.7, the reference's select_obj_ioa protocol) and strict 1-1
    (maximum-IoU matching by the host Jonker–Volgenant). Returns (grouped
    mIoU, per-object grouped IoUs, 1-1 mIoU, background IoU)."""
    gt_classes = n_objects + 1
    inter = np.zeros((n_pred_classes, gt_classes), np.int64)
    parea = np.zeros(n_pred_classes, np.int64)
    garea = np.zeros(gt_classes, np.int64)
    for p, gt in zip(pred, gts):
        idx = p.astype(np.int64) * gt_classes + gt.astype(np.int64)
        inter += np.bincount(idx.ravel(),
                             minlength=n_pred_classes * gt_classes
                             ).reshape(n_pred_classes, gt_classes)
        parea += np.bincount(p.ravel(), minlength=n_pred_classes)
        garea += np.bincount(gt.ravel(), minlength=gt_classes)
    iou = inter / np.maximum(parea[:, None] + garea[None, :] - inter, 1)

    ioa = inter / np.maximum(parea[:, None], 1)
    grouped = []
    for gt_cls in range(1, gt_classes):
        sel = np.flatnonzero(ioa[1:, gt_cls] > 0.7) + 1   # skip pred bg 0
        si = inter[sel, gt_cls].sum()
        sp = parea[sel].sum()
        grouped.append(float(si / max(sp + garea[gt_cls] - si, 1)))

    dim = max(n_pred_classes, gt_classes)
    cost = np.zeros((dim, dim), np.float32)
    cost[:n_pred_classes, :gt_classes] = -iou
    col_of_row = linear_sum_assignment(cost)[0]
    per_obj = {}
    for p_cls in range(n_pred_classes):
        gt_cls = int(col_of_row[p_cls])
        if gt_cls < gt_classes and iou[p_cls, gt_cls] > 0:
            per_obj[gt_cls] = float(iou[p_cls, gt_cls])
    obj_ious = [per_obj.get(k, 0.0) for k in range(1, gt_classes)]
    return float(np.mean(grouped)), grouped, float(np.mean(obj_ious)), per_obj.get(0, 0.0)


@torch.no_grad()
def predict_identity_maps(state, Rs, ts, fx, fy, H, W, raster_kw, device="cuda"):
    """Post-train: 16-channel identity renders per view classified with the
    trained codebook (argmax, the first maximum, as the LERF mask CLI),
    background gated by alpha. Returns (class maps, class count + 1, logit
    maps [256, H, W], alphas)."""
    code_book = state.code_book.detach()
    preds, logit_maps, alphas = [], [], []
    for Rwc, t in zip(Rs, ts):
        cam = _camera(Rwc, t, fx, fy, H, W, device)
        out = render(state.table, cam, torch.zeros(3, device=device), **raster_kw)
        logits = torch.einsum("co,ohw->chw", code_book, out["render_object"])
        alpha = out["alpha"].cpu().numpy()
        pred = (torch.argmax(logits, dim=0) + 1).cpu().numpy()
        pred[alpha < 0.5] = 0
        preds.append(pred.astype(np.int32))
        logit_maps.append(logits.cpu().numpy())
        alphas.append(alpha)
    return preds, int(code_book.shape[0]) + 1, logit_maps, alphas


def lerf_protocol_eval(logit_maps, gts, alphas, seed: int = 0, feat_dim: int = 48,
                       noise: float = 0.05, n_objects: int = N_OBJECTS, device="cuda"):
    """The LERF-Masked protocol on the trained scene with meaningful features:
    each GT object gets an orthonormal synthetic "text embedding", frame 0's
    pixel features are painted from its GT map plus noise, and the text
    grounding (``text_query_mask`` on ``device``) → IoA selection → per-view
    export runs against known GT (mask IoU and boundary IoU). The export is
    argmax membership (the pixel's argmax id among the selected ids), as the
    JAX script's (its docstring says why), and a control prompt with a fresh
    embedding must export ~nothing."""
    rng = np.random.default_rng(seed + 7)
    names = [f"object-{k}" for k in range(1, n_objects + 1)]
    vocab_words = names + list(LERF_NEGATIVES) + ["control-concept"]
    q, _ = np.linalg.qr(rng.standard_normal((feat_dim, len(vocab_words))))
    emb = q.T.astype(np.float32)
    table = dict(zip(vocab_words, emb))

    class _Vocab:
        def encode_prompts(self, prompts):
            return np.stack([table[p] for p in prompts])

    gt0 = gts[0]
    fmap = np.empty((*gt0.shape, feat_dim), np.float32)
    fmap[:] = table["stuff"]
    for k in range(1, n_objects + 1):
        fmap[gt0 == k] = table[names[k - 1]]
    fmap += rng.normal(0, noise, fmap.shape).astype(np.float32)

    # each view's argmax ids gated by alpha (the orbit's empty space is no
    # selectable id), formed once per view where the JAX script forms them
    # once per object and view: the same maps
    ams = [np.where(al >= 0.5, lm.argmax(axis=0), -1) for lm, al in zip(logit_maps, alphas)]
    pred0 = ams[0]
    vocab = _Vocab()
    ious, bious = [], []
    for k in range(1, n_objects + 1):
        qmask = text_query_mask(fmap, names[k - 1], threshold=0.5, text_model=vocab,
                                device=device)
        ids = [i for i in select_obj_ioa(pred0, qmask, 0.7) if i >= 0]
        for am, gt in zip(ams, gts):
            sel = np.isin(am, ids) if ids else np.zeros(gt.shape, bool)
            ious.append(mask_iou(sel.astype(np.uint8) * 255,
                                 (gt == k).astype(np.uint8) * 255))
            bious.append(boundary_iou((gt == k).astype(np.uint8) * 255,
                                      sel.astype(np.uint8) * 255))
    ctrl_mask = text_query_mask(fmap, "control-concept", threshold=0.5,
                                text_model=vocab, device=device)
    ctrl_ids = [i for i in select_obj_ioa(pred0, ctrl_mask, 0.7) if i >= 0]
    ctrl_px = sum(int(np.isin(am, ctrl_ids).sum()) for am in ams) if ctrl_ids else 0
    ctrl_frac = ctrl_px / float(len(logit_maps) * gts[0].size)
    return {
        "lerf_mask_iou": float(np.mean(ious)),
        "lerf_boundary_iou": float(np.mean(bious)),
        "control_grounded_px_frac": float(ctrl_mask.mean()),
        "control_selected_ids": len(ctrl_ids),
        "control_export_px_frac": ctrl_frac,
    }


# ───────────────────────── the loop ─────────────────────────

def run_loop(root: str, frames: int, H: int, W: int, iterations: int,
             seed: int = 0, capacity: int = 4096, quiet: bool = False,
             consolidate: bool = False, max_per_tile: int = 512,
             label_source: str = "slic", n_objects: int = N_OBJECTS,
             layout: str = "fixed", textured: bool = False,
             slic_segments: int = 64, tracker_iou: float = 0.4,
             tracker_color_gate: float = 0.0, tracker_motion: bool = True,
             tracker_centroid_frac: float = 0.0, save_at: tuple = (),
             device: str = "cuda"):
    """The loop on ``device`` (the JAX script's ``run_loop``, whose docstring
    has its measured trade-offs). Returns the result dict it prints."""
    device = require_device(device)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    g = build_objects(rng, n_objects=n_objects, layout=layout, textured=textured)
    Rs, ts, fx, fy = orbit_cameras(frames, H, W)
    rgbs, gts = render_sweep(g, Rs, ts, fx, fy, H, W, max_per_tile=max_per_tile,
                             device=device)
    write_colmap_scene(root, g, Rs, ts, fx, fy, rgbs)
    t_render = time.perf_counter() - t0

    # pseudo-labels through the CLI's own segment and track functions
    # (label_source 'gt' writes the GT instance maps instead: the upper bound)
    t0 = time.perf_counter()
    seg_dir = os.path.join(root, "seg_raw")
    mask_dir = os.path.join(root, "object_mask")
    if label_source == "gt":
        os.makedirs(mask_dir, exist_ok=True)
        for f_i, gt in enumerate(gts):
            Image.fromarray(gt.astype(np.uint8)).save(
                os.path.join(mask_dir, f"frame_{f_i:03d}.png"))
    else:
        segment_images(os.path.join(root, "images"), seg_dir, n_segments=slic_segments,
                       compactness=12.0, merge_thresh=0.15, min_pixels=40,
                       device=device)
        track_sequence(seg_dir, mask_dir, iou_threshold=tracker_iou,
                       memory_frames=8, min_pixels=40,
                       consolidate_images=(os.path.join(root, "images")
                                           if consolidate else None),
                       motion=tracker_motion,
                       color_gate=tracker_color_gate,
                       gate_images=os.path.join(root, "images"),
                       centroid_fallback_frac=tracker_centroid_frac)
    tracked = [np.asarray(Image.open(os.path.join(mask_dir, f)))
               for f in sorted(os.listdir(mask_dir))]
    t_labels = time.perf_counter() - t0

    consistency, n_tracks = tracker_consistency(tracked, gts)

    # Unified-Lift training on the pseudo-labels
    t0 = time.perf_counter()
    opt = OptimizationConfig(
        iterations=iterations, densify_from_iter=200,
        densify_until_iter=max(iterations // 2, 201),
        densification_interval=100, opacity_reset_interval=10 ** 9,
        num_classes=256)
    run = TrainRunConfig(
        iterations=iterations, test_iterations=(),
        save_iterations=tuple(save_at),
        checkpoint_iterations=(), log_every=max(iterations // 4, 1),
        num_classes=256, raster_max_tiles_per_axis=6,
        raster_max_per_tile=max_per_tile, raster_tile_chunk=16,
        raster_backend=raster_backend(device))
    state = train(root, os.path.join(root, "model"), opt=opt, run=run,
                  capacity=capacity, device=device)
    t_train = time.perf_counter() - t0

    raster_kw = dict(max_tiles_per_axis=6, max_per_tile=max_per_tile, tile_chunk=16,
                     backend=raster_backend(device))
    preds, n_pred, logit_maps, alphas = predict_identity_maps(
        state, Rs, ts, fx, fy, H, W, raster_kw, device=device)
    miou, obj_ious, miou_1to1, bg_iou = match_miou(preds, gts, n_pred,
                                                   n_objects=n_objects)
    lerf = lerf_protocol_eval(logit_maps, gts, alphas, seed=seed, n_objects=n_objects,
                              device=device)

    # post-train codebook-class consolidation, re-scored on both protocols;
    # its raw inputs are kept so the merge can be iterated offline
    table = state.table
    objects_dc = table.objects_dc.detach().reshape(table.capacity, -1).cpu().numpy()
    code_book = state.code_book.detach().cpu().numpy()
    xyz = table.xyz.detach().cpu().numpy()
    active = table.active.cpu().numpy()
    np.savez_compressed(os.path.join(root, "merge_debug.npz"), objects_dc=objects_dc,
                        code_book=code_book, xyz=xyz, active=active,
                        preds=np.stack(preds), gts=np.stack(gts))
    merge_stats = {}
    remap = consolidate_classes(objects_dc, code_book, xyz, active=active,
                                stats=merge_stats)
    preds_m = [remap[p] for p in preds]
    miou_m, _, miou_1to1_m, _ = match_miou(preds_m, gts, n_pred, n_objects=n_objects)
    used = np.unique(np.concatenate([np.unique(p) for p in preds]))
    used = used[used > 0]
    n_used_before = int(len(used))
    n_merged = int(len(np.unique(remap[used])))

    result = {
        "tracker_consistency": round(consistency, 4),
        "n_tracks": n_tracks,
        "post_train_identity_miou_grouped": round(miou, 4),
        "per_object_iou_grouped": [round(x, 4) for x in obj_ious],
        "post_train_identity_miou_1to1": round(miou_1to1, 4),
        "class_merge": {"grouped": round(miou_m, 4),
                        "strict_1to1": round(miou_1to1_m, 4),
                        "rendered_classes_before": n_used_before,
                        "rendered_classes_after": n_merged,
                        "stats": merge_stats},
        "background_iou": round(bg_iou, 4),
        "lerf": {k: round(v, 4) if isinstance(v, float) else v
                 for k, v in lerf.items()},
        "config": {"frames": frames, "hw": [H, W], "iterations": iterations,
                   "n_objects": n_objects, "layout": layout,
                   "textured": textured, "capacity": capacity,
                   "label_source": label_source,
                   "max_per_tile": max_per_tile,
                   "tracker": {"iou": tracker_iou,
                               "color_gate": tracker_color_gate,
                               "motion": tracker_motion,
                               "centroid_frac": tracker_centroid_frac}},
        "timings_s": {"render_sweep": round(t_render, 1),
                      "pseudo_labels": round(t_labels, 1),
                      "train": round(t_train, 1)},
    }
    if not quiet:
        print(json.dumps(result))
    return result


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--out", default=os.path.join("output", "pseudo_loop"))
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--consolidate", action="store_true",
                   help="apply the in-clip consensus track merge (trades "
                        "grouped/LERF IoU for strict 1-1 compactness — see "
                        "run_loop docstring)")
    p.add_argument("--label_source", choices=("slic", "gt"), default="slic",
                   help="'gt' trains on the GT instance maps — the upper "
                        "bound isolating training/render quality from the "
                        "SLIC+track label quality")
    p.add_argument("--n_objects", type=int, default=N_OBJECTS)
    p.add_argument("--layout", choices=("fixed", "random"), default="fixed",
                   help="'random' packs the objects with occlusions")
    p.add_argument("--textured", action="store_true",
                   help="two-tone plane-wave surface textures per object")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slic_segments", type=int, default=64,
                   help="SLIC superpixel count (scale with object count "
                        "and resolution; 64 fits the 5-object 128 px scene)")
    p.add_argument("--max_per_tile", type=int, default=512,
                   help="per-tile blend K cap for train AND eval renders — "
                        "the K-cap truncation A/B knob (reference blends "
                        "unbounded per-tile lists)")
    p.add_argument("--tracker_iou", type=float, default=0.4)
    p.add_argument("--tracker_color_gate", type=float, default=0.0,
                   help="appearance-veto distance (scripts/tune_tracker.py "
                        "measured 0.25 + iou 0.3 + motion best on the hard "
                        "scene)")
    p.add_argument("--no_tracker_motion", action="store_true")
    p.add_argument("--tracker_centroid_frac", type=float, default=0.0)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--save_at", default="",
                   help="comma-separated iterations for mid-train point-cloud "
                        "snapshots, harvestable by "
                        "the JAX package's scripts/eval_hard_scene_checkpoint.py")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    save_at = tuple(int(x) for x in args.save_at.split(",") if x.strip())
    run_loop(args.out, args.frames, args.size, args.size, args.iterations,
             capacity=args.capacity, consolidate=args.consolidate,
             label_source=args.label_source, n_objects=args.n_objects,
             layout=args.layout, textured=args.textured, seed=args.seed,
             slic_segments=args.slic_segments,
             max_per_tile=args.max_per_tile, tracker_iou=args.tracker_iou,
             tracker_color_gate=args.tracker_color_gate,
             tracker_motion=not args.no_tracker_motion,
             tracker_centroid_frac=args.tracker_centroid_frac,
             save_at=save_at, device=args.device)


if __name__ == "__main__":
    main()
