"""Offline sweep of the tracker on a pseudo-label-loop scene, the port's twin
of scripts/tune_tracker.py (the same arguments; host numpy and the host
Jonker–Volgenant, nothing on a device):

    python -m segsplat_tpu_torch.tune_tracker ROOT [--gts merge_debug.npz] [--n_objects 20]
        [--out rows.json]

Scores association variants (motion prediction, the colour gate, thresholds,
the centroid fallback, each with and without the in-clip consensus merge)
directly against the GT instance maps the loop saves: the tracked label maps
are taken as predictions under the loop's two mIoU protocols, an upper proxy
for what training can learn from them (the reference's DEVA script,
script/debug_checks_scripts/prepare_pseudo_label.sh:24-57).
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
from PIL import Image

from segsplat_tpu_torch.pipeline.tracking import (ConsolidateConfig, TrackerConfig,
                                                  associate_sequence, consolidate_tracks)
from segsplat_tpu_torch.prepare_pseudo_label import _load_frame_ids
from segsplat_tpu_torch.pseudo_label_loop import match_miou, tracker_consistency

_BASE = dict(iou_threshold=0.4, memory_frames=8, min_pixels=40)
# (name, TrackerConfig keywords, whether the variant gates on the images)
VARIANTS = (
    ("baseline iou=0.4 mem=8", dict(_BASE, motion=False), False),
    ("motion", dict(_BASE, motion=True), False),
    ("motion+gate0.15", dict(_BASE, motion=True, color_gate=0.15), True),
    ("motion+gate0.25", dict(_BASE, motion=True, color_gate=0.25), True),
    ("motion iou=0.3", dict(_BASE, iou_threshold=0.3, motion=True), False),
    ("motion iou=0.3 gate0.25", dict(_BASE, iou_threshold=0.3, motion=True,
                                     color_gate=0.25), True),
    ("motion mem=15 gate0.25", dict(_BASE, memory_frames=15, motion=True,
                                    color_gate=0.25), True),
    ("best+centroid1.5", dict(_BASE, iou_threshold=0.3, motion=True, color_gate=0.25,
                              centroid_fallback_frac=1.5), True),
    ("best+centroid3.0", dict(_BASE, iou_threshold=0.3, motion=True, color_gate=0.25,
                              centroid_fallback_frac=3.0), True),
)


def load_inputs(root: str, gts_npz: str):
    """(raw SLIC id maps of root/seg_raw, root/images' frames, the GT maps)."""
    seg_dir = os.path.join(root, "seg_raw")
    seg = [_load_frame_ids(os.path.join(seg_dir, f))
           for f in sorted(f for f in os.listdir(seg_dir) if f.endswith(".png"))]
    img_dir = os.path.join(root, "images")
    images = [np.asarray(Image.open(os.path.join(img_dir, f)).convert("RGB"))
              for f in sorted(f for f in os.listdir(img_dir)
                              if f.lower().endswith((".png", ".jpg")))]
    gts = [g for g in np.load(gts_npz)["gts"]]
    if not len(seg) == len(images) == len(gts):
        raise ValueError(f"{len(seg)} id maps, {len(images)} images and {len(gts)} GT maps")
    return seg, images, gts


def score(tracked, gts, n_objects: int) -> dict:
    consistency, n_tracks = tracker_consistency(tracked, gts)
    n_pred = int(max(int(t.max()) for t in tracked)) + 1
    grouped, obj_ious, strict, _ = match_miou(tracked, gts, n_pred, n_objects=n_objects)
    return {"n_tracks": n_tracks, "consistency": round(consistency, 4),
            "label_miou_grouped": round(grouped, 4),
            "label_miou_strict": round(strict, 4),
            "objects_covered@0.5": int(sum(x > 0.5 for x in obj_ious)),
            "objects_lost@0.1": int(sum(x < 0.1 for x in obj_ious))}


def main(argv=None) -> list:
    p = ArgumentParser()
    p.add_argument("root", help="run root with seg_raw/ and images/")
    p.add_argument("--gts", default=None,
                   help="npz with the GT instance maps (default: root/merge_debug.npz)")
    p.add_argument("--n_objects", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    seg, images, gts = load_inputs(args.root,
                                   args.gts or os.path.join(args.root, "merge_debug.npz"))
    results = []
    for name, kw, use_img in VARIANTS:
        tracked = associate_sequence(seg, TrackerConfig(**kw),
                                     images=images if use_img else None)
        for label, maps in ((name, tracked),
                            (name + " +consolidate",
                             consolidate_tracks(tracked, images, ConsolidateConfig()))):
            row = {"variant": label, **score(maps, gts, args.n_objects)}
            results.append(row)
            print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
