"""ScanNet++ semantic evaluation, the port's twin of scripts/eval_scannetpp.py
(the same flags): mIoU / fwIoU over rendered label maps against GT label maps
(the protocol of README.md:101-103; ``render_scannetpp_gt`` renders the GT
from the annotated mesh). Host numpy in both packages.

    python -m segsplat_tpu_torch.eval_scannetpp --pred_dir P --gt_dir G --num_classes N

Inputs: two directories of per-view label maps (``*_labels.pt`` / ``.npy`` /
``.png``), matched by basename prefix."""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.eval.metrics import (confusion_matrix, iou_per_class,
                                             miou_from_confusion)
from segsplat_tpu_torch.io.artifacts import load_label_map
from segsplat_tpu_torch.io.provenance import read_weights_source, require_untainted


def _load(path: str) -> np.ndarray:
    if path.endswith((".pt", ".npy")):
        return np.asarray(load_label_map(path) if path.endswith(".pt")
                          else np.load(path))
    from PIL import Image
    return np.asarray(Image.open(path))


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--ignore_label", type=int, default=-1)
    p.add_argument("--labels", nargs="*", default=None,
                   help="optional class names for the per-class report")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="accept predictions tainted weights_source=random")
    p.add_argument("--require_provenance", action="store_true",
                   help="strict mode: also reject UNSTAMPED predictions "
                        "(io/provenance.py — default accepts pre-provenance "
                        "artifacts)")
    args = p.parse_args(argv)
    require_untainted(read_weights_source(args.pred_dir),
                      args.allow_random_weights,
                      f"prediction dir {args.pred_dir}",
                      strict=args.require_provenance)
    preds = sorted(glob.glob(os.path.join(args.pred_dir, "*_labels.pt")))
    if not preds:  # fall back to any label-map-like files
        preds = sorted(glob.glob(os.path.join(args.pred_dir, "*.npy"))
                       + glob.glob(os.path.join(args.pred_dir, "*.png")))
    if not preds:
        raise SystemExit(f"no prediction label maps in {args.pred_dir}")
    conf = np.zeros((args.num_classes, args.num_classes), np.int64)
    matched = 0
    for pp in preds:
        base = os.path.basename(pp).split("_labels")[0].split(".")[0]
        # prefer GT files that look like label maps over other artifacts
        gts = (glob.glob(os.path.join(args.gt_dir, base + "*label*"))
               or glob.glob(os.path.join(args.gt_dir, base + ".*")))
        if not gts:
            continue
        pred = _load(pp)
        gt = _load(gts[0])
        if pred.shape != gt.shape:
            from PIL import Image
            pred = np.asarray(Image.fromarray(pred.astype(np.int32), "I").resize(
                (gt.shape[1], gt.shape[0]), Image.NEAREST))
        conf += confusion_matrix(pred, gt, args.num_classes, args.ignore_label)
        matched += 1
    if matched == 0:
        raise SystemExit("no matched prediction/GT pairs")

    iou = iou_per_class(conf)
    miou = miou_from_confusion(conf)
    freq = conf.sum(axis=1) / max(conf.sum(), 1)
    fwiou = float(np.nansum(np.where(np.isnan(iou), 0.0, iou) * freq))
    print(f"{matched} views | mIoU {miou:.4f} | fwIoU {fwiou:.4f}")
    for cid in np.flatnonzero(~np.isnan(iou)):
        name = (args.labels[cid] if args.labels and cid < len(args.labels)
                else f"class{cid}")
        print(f"  {name:24s} IoU {iou[cid]:.4f}  freq {freq[cid]:.4f}")


if __name__ == "__main__":
    main()
