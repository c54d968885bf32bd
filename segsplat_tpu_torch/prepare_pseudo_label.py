"""Pseudo-label preparation, the port's twin of scripts/prepare_pseudo_label.py
(same subcommands, arguments and defaults; ``segment`` takes ``--device``):

    python -m segsplat_tpu_torch.prepare_pseudo_label segment --images IMGS --out SEG [--device cuda|cpu]
    python -m segsplat_tpu_torch.prepare_pseudo_label track --masks SEG --out object_mask

The file-format glue of the reference's
prepare_pseudo_label.sh (script/debug_checks_scripts/prepare_pseudo_label.sh:24-57),
which runs DEVA twice (color masks + --use_short_id gray id masks).

DEVA/SAM/GroundingDINO are external vendored models with their own checkpoints
(Tracking-Anything-with-DEVA/, ~11.4k LoC in the reference); this tool covers
the pipeline contract around them:
  * ``convert``: color instance masks → gray id masks (``object_mask/``), the
    format train.py consumes per camera (dataset_readers.py:105-106),
  * ``track``: DEVA-lite — per-frame instance masks with ARBITRARY ids →
    temporally-consistent ids via max-IoU Hungarian association with
    occlusion memory (pipeline/tracking.py); ``object_mask/`` can be produced
    in-framework from any per-frame segmenter output,
  * ``from_deva``: invoke an external DEVA installation when available
    (--deva_cmd), then convert its output.
"""

from __future__ import annotations

import glob
import os
import subprocess
from argparse import ArgumentParser

import numpy as np
from PIL import Image

from segsplat_tpu_torch.pipeline.segment import SegmentConfig, segment_image
from segsplat_tpu_torch.pipeline.tracking import (ConsolidateConfig, TrackerConfig,
                                                  associate_sequence, consolidate_tracks)


def color_masks_to_ids(mask_dir: str, out_dir: str) -> int:
    """Map distinct colors to stable small ids across the sequence (DEVA's
    --use_short_id output equivalent)."""
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(sum((glob.glob(os.path.join(mask_dir, e))
                        for e in ("*.png", "*.jpg")), []))
    if not files:
        raise SystemExit(f"no masks in {mask_dir}")
    color_to_id = {(0, 0, 0): 0}
    for f in files:
        arr = np.asarray(Image.open(f).convert("RGB"))
        flat = arr.reshape(-1, 3)
        colors = np.unique(flat, axis=0)
        ids = np.zeros(len(colors), np.uint8)
        for i, c in enumerate(colors):
            key = tuple(int(x) for x in c)
            if key not in color_to_id:
                color_to_id[key] = len(color_to_id) % 256
            ids[i] = color_to_id[key]
        # vectorized recolor via a lookup over the per-image unique colors
        lut = {tuple(int(x) for x in c): ids[i] for i, c in enumerate(colors)}
        keys = (flat[:, 0].astype(np.int64) << 16) | \
               (flat[:, 1].astype(np.int64) << 8) | flat[:, 2].astype(np.int64)
        ckeys = (colors[:, 0].astype(np.int64) << 16) | \
                (colors[:, 1].astype(np.int64) << 8) | colors[:, 2].astype(np.int64)
        order = np.argsort(ckeys)
        pos = np.searchsorted(ckeys[order], keys)
        out = ids[order][pos].reshape(arr.shape[:2])
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        Image.fromarray(out).save(os.path.join(out_dir, name))
    print(f"[DONE] {len(files)} masks, {len(color_to_id)} object ids → {out_dir}")
    return len(color_to_id)


def _load_frame_ids(path: str) -> np.ndarray:
    """A mask file → per-frame id map (gray ids verbatim; RGB colors get
    arbitrary per-frame ids — the tracker re-associates them anyway)."""
    img = Image.open(path)
    if img.mode in ("L", "P", "I", "I;16"):
        return np.asarray(img.convert("I")).astype(np.int32)
    arr = np.asarray(img.convert("RGB"))
    flat = (arr[..., 0].astype(np.int64) << 16) | \
           (arr[..., 1].astype(np.int64) << 8) | arr[..., 2].astype(np.int64)
    colors, ids = np.unique(flat, return_inverse=True)
    ids = ids.reshape(arr.shape[:2]).astype(np.int32)
    if colors[0] != 0:                      # keep black = background = 0
        ids += 1
    return ids


def _load_images(image_dir: str, n_expected: int) -> list:
    imgs = sorted(f for f in os.listdir(image_dir)
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if len(imgs) != n_expected:
        raise SystemExit(f"{image_dir}: {len(imgs)} images for "
                         f"{n_expected} masks")
    return [np.asarray(Image.open(os.path.join(image_dir, f)).convert("RGB"))
            for f in imgs]


def track_sequence(mask_dir: str, out_dir: str, iou_threshold: float,
                   memory_frames: int, min_pixels: int,
                   consolidate_images: str | None = None,
                   adjacency_frac: float = 0.5,
                   color_thresh: float = 0.10,
                   motion: bool = True,
                   color_gate: float = 0.0,
                   gate_images: str | None = None,
                   centroid_fallback_frac: float = 0.0) -> int:
    """DEVA-lite: associate per-frame instances across the sequence; with
    ``consolidate_images`` set, follow with the in-clip consensus merge
    (pipeline/tracking.consolidate_tracks) that fuses region-level tracks
    into object-level ids using whole-sweep adjacency + color evidence.
    ``motion``/``color_gate`` drive the association-time upgrades
    (constant-velocity mask prediction, appearance veto — gate_images
    supplies the RGB frames when consolidate is off)."""
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(sum((glob.glob(os.path.join(mask_dir, e))
                        for e in ("*.png", "*.jpg")), []))
    if not files:
        raise SystemExit(f"no masks in {mask_dir}")
    frames = (_load_frame_ids(f) for f in files)
    cfg = TrackerConfig(iou_threshold=iou_threshold,
                        memory_frames=memory_frames, min_pixels=min_pixels,
                        motion=motion, color_gate=color_gate,
                        centroid_fallback_frac=centroid_fallback_frac)
    gate_dir = gate_images or consolidate_images
    images = (_load_images(gate_dir, len(files))
              if (color_gate > 0 and gate_dir) else None)
    tracked = associate_sequence(frames, cfg, images=images)
    if consolidate_images is not None:
        if images is None or gate_dir != consolidate_images:
            images = _load_images(consolidate_images, len(files))
        tracked = consolidate_tracks(
            tracked, images, ConsolidateConfig(
                adjacency_frac=adjacency_frac, color_thresh=color_thresh))
    n_ids = 0
    for f, t in zip(files, tracked):
        n_ids = max(n_ids, int(t.max()))
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        Image.fromarray(t).save(os.path.join(out_dir, name))
    print(f"[DONE] tracked {len(files)} frames, {n_ids} object ids → {out_dir}")
    return n_ids


def segment_images(image_dir: str, out_dir: str, n_segments: int,
                   compactness: float, merge_thresh: float,
                   min_pixels: int, device: str = "cuda") -> int:
    """Raw frames → per-frame instance-id maps via pipeline/segment.py, SLIC on
    ``device``."""
    cfg = SegmentConfig(n_segments=n_segments, compactness=compactness,
                        merge_thresh=merge_thresh, min_pixels=min_pixels)
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    n = 0
    for f in files:
        img = np.asarray(Image.open(os.path.join(image_dir, f)).convert("RGB"))
        ids = segment_image(img, cfg, device=device)
        if ids.max() > 255:
            # uint8 id budget: keep the 255 largest regions, remap the rest
            # to background 0 (a clip would fuse all overflow regions into
            # one bogus instance at id 255)
            sizes = np.bincount(ids.ravel())
            keep = np.argsort(sizes)[::-1]
            keep = keep[keep > 0][:255]
            remap = np.zeros(sizes.size, np.int32)
            remap[keep] = np.arange(1, len(keep) + 1)
            print(f"[WARN] {f}: {ids.max()} regions > 255; kept the 255 "
                  f"largest, {int((remap[ids] == 0).sum())} px now "
                  f"background (raise merge_thresh / min_pixels)")
            ids = remap[ids]
        name = os.path.splitext(f)[0] + ".png"
        Image.fromarray(ids.astype(np.uint8)).save(os.path.join(out_dir, name))
        n += 1
    print(f"[DONE] segmented {n} frames → {out_dir}")
    return n


def main(argv=None):
    p = ArgumentParser()
    sp = p.add_subparsers(dest="cmd", required=True)

    cv = sp.add_parser("convert", help="color masks → gray id masks")
    cv.add_argument("--masks", required=True)
    cv.add_argument("--out", required=True)

    tr = sp.add_parser("track", help="DEVA-lite temporal id association")
    tr.add_argument("--masks", required=True,
                    help="per-frame masks (gray ids or colors, any ids)")
    tr.add_argument("--out", required=True)
    tr.add_argument("--iou_threshold", type=float, default=0.3)
    tr.add_argument("--memory_frames", type=int, default=30)
    tr.add_argument("--min_pixels", type=int, default=16)
    tr.add_argument("--consolidate_images", default=None,
                    help="RGB frame dir; enables the in-clip consensus merge "
                    "of region tracks into object ids (DEVA-style)")
    tr.add_argument("--adjacency_frac", type=float, default=0.5)
    tr.add_argument("--color_thresh", type=float, default=0.10)
    tr.add_argument("--no_motion", action="store_true",
                    help="disable constant-velocity mask prediction")
    tr.add_argument("--color_gate", type=float, default=0.0,
                    help="mean-RGB distance vetoing a link (0 = off; "
                         "needs --gate_images or --consolidate_images)")
    tr.add_argument("--gate_images", default=None,
                    help="RGB frame dir for the appearance gate")
    tr.add_argument("--centroid_fallback_frac", type=float, default=0.0,
                    help="second-pass centroid match radius in units of "
                         "sqrt(instance area); bootstraps velocity for fast "
                         "movers (0 = off)")

    sg = sp.add_parser("segment", help="in-framework per-frame instance "
                       "proposals (SLIC + region merge, pipeline/segment.py) "
                       "— the zero-external-weights mask source; chain with "
                       "'track' for temporally consistent ids")
    sg.add_argument("--images", required=True)
    sg.add_argument("--out", required=True)
    sg.add_argument("--n_segments", type=int, default=256)
    sg.add_argument("--compactness", type=float, default=0.25)
    sg.add_argument("--merge_thresh", type=float, default=0.08)
    sg.add_argument("--min_pixels", type=int, default=64)
    sg.add_argument("--device", default="cuda", help="where SLIC runs: cuda or cpu")

    dv = sp.add_parser("from_deva", help="run an external DEVA then convert")
    dv.add_argument("--deva_cmd", required=True,
                    help="shell command that writes color masks to --masks")
    dv.add_argument("--masks", required=True)
    dv.add_argument("--out", required=True)

    args = p.parse_args(argv)
    if args.cmd == "segment":
        segment_images(args.images, args.out, args.n_segments,
                       args.compactness, args.merge_thresh, args.min_pixels,
                       device=args.device)
        return
    if args.cmd == "track":
        track_sequence(args.masks, args.out, args.iou_threshold,
                       args.memory_frames, args.min_pixels,
                       consolidate_images=args.consolidate_images,
                       adjacency_frac=args.adjacency_frac,
                       color_thresh=args.color_thresh,
                       motion=not args.no_motion,
                       color_gate=args.color_gate,
                       gate_images=args.gate_images,
                       centroid_fallback_frac=args.centroid_fallback_frac)
        return
    if args.cmd == "from_deva":
        print(f"+ {args.deva_cmd}")
        r = subprocess.run(args.deva_cmd, shell=True)
        if r.returncode != 0:
            raise SystemExit(f"DEVA command failed ({r.returncode})")
    color_masks_to_ids(args.masks, args.out)


if __name__ == "__main__":
    main()
