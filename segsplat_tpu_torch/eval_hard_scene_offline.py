"""Offline re-score of a pseudo-label-loop run from its saved merge inputs,
the port's twin of scripts/eval_hard_scene_offline.py (the same arguments):

    python -m segsplat_tpu_torch.eval_hard_scene_offline ROOT_OR_NPZ [--n_objects 20]
        [--mix_threshold T] [--feat_threshold T]

``pseudo_label_loop`` saves ``merge_debug.npz`` (preds, gts, objects_dc,
code_book, xyz, active) before its final metrics, so a finished run can be
re-scored without training again: both mIoU protocols (grouped and strict
1-1) and the post-train class consolidation. Host numpy and the host
Jonker–Volgenant; nothing runs on a device. Prints one JSON line.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from typing import Optional

import numpy as np

from segsplat_tpu_torch.pipeline.consolidate import ClassMergeConfig, consolidate_classes
from segsplat_tpu_torch.pseudo_label_loop import match_miou


def rescore(npz_path: str, n_objects: int, mix_threshold: Optional[float] = None,
            feat_threshold: Optional[float] = None) -> dict:
    """The loop's identity metrics and class-merge block from ``npz_path``,
    with the merge's thresholds overridden where given."""
    d = np.load(npz_path)
    preds = [p for p in d["preds"]]
    gts = [g for g in d["gts"]]
    n_pred = int(d["code_book"].shape[0]) + 1

    miou, obj_ious, miou_1to1, bg_iou = match_miou(preds, gts, n_pred, n_objects=n_objects)

    cfg = ClassMergeConfig()
    if mix_threshold is not None:
        cfg = ClassMergeConfig(mix_threshold=mix_threshold, feat_threshold=cfg.feat_threshold)
    if feat_threshold is not None:
        cfg = ClassMergeConfig(mix_threshold=cfg.mix_threshold, feat_threshold=feat_threshold)
    merge_stats: dict = {}
    remap = consolidate_classes(d["objects_dc"].reshape(d["objects_dc"].shape[0], -1),
                                d["code_book"], d["xyz"], active=d["active"], cfg=cfg,
                                stats=merge_stats)
    preds_m = [remap[p] for p in preds]
    miou_m, _, miou_1to1_m, _ = match_miou(preds_m, gts, n_pred, n_objects=n_objects)
    used = np.unique(np.concatenate([np.unique(p) for p in preds]))
    used = used[used > 0]
    return {
        "post_train_identity_miou_grouped": round(miou, 4),
        "per_object_iou_grouped": [round(x, 4) for x in obj_ious],
        "post_train_identity_miou_1to1": round(miou_1to1, 4),
        "background_iou": round(bg_iou, 4),
        "class_merge": {"grouped": round(miou_m, 4),
                        "strict_1to1": round(miou_1to1_m, 4),
                        "rendered_classes_before": int(len(used)),
                        "rendered_classes_after": int(len(np.unique(remap[used]))),
                        "mix_threshold": cfg.mix_threshold,
                        "feat_threshold": cfg.feat_threshold,
                        "stats": merge_stats},
    }


def main(argv=None) -> dict:
    p = ArgumentParser()
    p.add_argument("root", help="run root (or direct merge_debug.npz path)")
    p.add_argument("--n_objects", type=int, default=20)
    p.add_argument("--mix_threshold", type=float, default=None)
    p.add_argument("--feat_threshold", type=float, default=None)
    args = p.parse_args(argv)

    npz = args.root if args.root.endswith(".npz") else os.path.join(args.root,
                                                                    "merge_debug.npz")
    out = rescore(npz, args.n_objects, mix_threshold=args.mix_threshold,
                  feat_threshold=args.feat_threshold)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
