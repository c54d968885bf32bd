"""LERF-Masked evaluation, the port's twin of scripts/eval_lerf_mask.py (the
same flags): per-mask IoU and boundary IoU → CSV, a drop-in for the
reference's script/eval_lerf_mask_unified_lift.py (:83-168). Host numpy in
both packages.

    python -m segsplat_tpu_torch.eval_lerf_mask --gt_root GT --pred_root PRED --scenes S ...
"""

from __future__ import annotations

import csv
import glob
import os
from argparse import ArgumentParser

import numpy as np
from PIL import Image

from segsplat_tpu_torch.eval.metrics import boundary_iou, mask_iou
from segsplat_tpu_torch.io.provenance import read_weights_source, require_untainted

SCENES = ("figurines", "ramen", "teatime")


def eval_scene(gt_dir: str, pred_dir: str) -> list:
    rows = []
    for gt_path in sorted(glob.glob(os.path.join(gt_dir, "*", "*.png")) +
                          glob.glob(os.path.join(gt_dir, "*.png"))):
        rel = os.path.relpath(gt_path, gt_dir)
        pred_path = os.path.join(pred_dir, rel)
        if not os.path.exists(pred_path):
            print(f"[WARN] missing prediction {rel}")
            continue
        gt = np.asarray(Image.open(gt_path).convert("L"))
        pred = np.asarray(Image.open(pred_path).convert("L").resize(
            (gt.shape[1], gt.shape[0]), Image.NEAREST))
        rows.append({
            "mask": rel,
            "iou": mask_iou(pred, gt),
            "biou": boundary_iou(gt, pred),
        })
    return rows


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--gt_root", required=True,
                   help="root with <scene>/ GT mask PNG dirs")
    p.add_argument("--pred_root", required=True)
    p.add_argument("--scenes", nargs="+", default=list(SCENES))
    p.add_argument("--out_csv", default="lerf_eval.csv")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="accept predictions tainted weights_source=random")
    p.add_argument("--require_provenance", action="store_true",
                   help="strict mode: also reject UNSTAMPED predictions "
                        "(io/provenance.py — default accepts pre-provenance "
                        "artifacts)")
    args = p.parse_args(argv)
    all_rows = []
    for scene in args.scenes:
        pred_dir = os.path.join(args.pred_root, scene)
        require_untainted(read_weights_source(pred_dir),
                          args.allow_random_weights,
                          f"prediction dir {pred_dir}",
                          strict=args.require_provenance)
        rows = eval_scene(os.path.join(args.gt_root, scene), pred_dir)
        for r in rows:
            r["scene"] = scene
        all_rows += rows
        if rows:
            miou = np.mean([r["iou"] for r in rows])
            mbiou = np.mean([r["biou"] for r in rows])
            print(f"{scene}: mIoU={miou:.4f} mBIoU={mbiou:.4f} ({len(rows)} masks)")

    with open(args.out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["scene", "mask", "iou", "biou"])
        w.writeheader()
        w.writerows(all_rows)
    if all_rows:
        print(f"ALL: mIoU={np.mean([r['iou'] for r in all_rows]):.4f} "
              f"mBIoU={np.mean([r['biou'] for r in all_rows]):.4f}")
    print(f"[DONE] → {args.out_csv}")


if __name__ == "__main__":
    main()
