#!/usr/bin/env python
"""Parity against the reference's own label maps (the twin of
scripts/parity_real.py): per-view label maps that the reference pipeline wrote
(voxel_to_gaussian/semantics_*/train/labels/*_labels.pt, written by
render_semantics_logits.py:141-143: {'label_indices': [584, 876] int64}).

Three checks, on the port's ``io/artifacts`` and ``eval/metrics``:

  A. the bit-exact load/save round trip of each sampled file: values, dtype
     and shape survive a .pt → port → .pt cycle unchanged;
  B. the pixel share of each class, per variant (the 13 officescene prompts
     of voxeltoGaussian_logits.sh);
  C. the confusion matrix, pixel accuracy, mIoU and fwIoU between each pair of
     variants (the same 216-view officescene sweep from three voxel grids),
     with each pair's per-class IoU.

    python -m segsplat_tpu_torch.parity_real --ref_root DIR --out REPORT.md [--max_views N]

``--ref_root`` is the directory that holds the ``semantics_*`` variants and
``--out`` the report to write; both are required, and nothing else is
written.
"""

from __future__ import annotations

import glob
import os
import tempfile
import time
from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.eval.metrics import confusion_matrix, iou_per_class, miou_from_confusion
from segsplat_tpu_torch.io.artifacts import load_label_map, save_label_map

# The 13 officescene prompts the reference used to produce these label maps
# (voxeltoGaussian_logits.sh PROMPTS=...; class id == prompt position).
OFFICESCENE_PROMPTS = ["chair", "cabinet", "window", "wall", "door", "keyboard",
                       "ceiling", "floor", "table", "laptop", "paper", "light",
                       "monitor"]

VARIANTS = ["semantics_87319_30000_NEW", "semantics_195120_30000_train",
            "semantics_195120_30000_train_NEW"]
REFERENCE_SHAPE = (584, 876)


def find_variants(ref_root: str) -> dict:
    """{variant: sorted label files} for each variant with files under ``ref_root``."""
    out = {}
    for v in VARIANTS:
        files = sorted(glob.glob(os.path.join(ref_root, v, "train", "labels", "*_labels.pt")))
        if files:
            out[v] = files
    return out


def roundtrip_check(files, sample: int = 8) -> int:
    """A: load each of ``sample`` evenly spaced files, save it again through the
    port's writer, reload, and require the same values, dtype, shape and key
    set. Returns the files checked."""
    idxs = np.linspace(0, len(files) - 1, min(sample, len(files))).astype(int)
    checked = 0
    with tempfile.TemporaryDirectory() as td:
        for i in idxs:
            src = files[int(i)]
            ref_arr = torch.load(src, map_location="cpu", weights_only=True)["label_indices"].numpy()
            ours = load_label_map(src)
            if ours.dtype != ref_arr.dtype or ours.shape != ref_arr.shape:
                raise ValueError(f"{src}: loader changed dtype/shape {ours.dtype}{ours.shape}")
            if not np.array_equal(ours, ref_arr):
                raise ValueError(f"{src}: loader changed values")
            dst = os.path.join(td, os.path.basename(src))
            save_label_map(dst, ours)
            back = torch.load(dst, map_location="cpu", weights_only=True)
            if set(back.keys()) != {"label_indices"}:
                raise ValueError(f"{dst}: wrong key set {set(back.keys())}")
            back_arr = back["label_indices"].numpy()
            if back_arr.dtype != ref_arr.dtype:
                raise ValueError(f"{dst}: dtype drift {back_arr.dtype} vs {ref_arr.dtype}")
            if not np.array_equal(back_arr, ref_arr):
                raise ValueError(f"{dst}: value drift")
            checked += 1
    return checked


def histogram(files, num_classes: int):
    """B: (pixels of each class [num_classes] int64, the set of map shapes)."""
    counts = np.zeros(num_classes, np.int64)
    shapes = set()
    for f in files:
        arr = load_label_map(f)
        shapes.add(arr.shape)
        counts += np.bincount(arr.ravel(), minlength=num_classes)[:num_classes]
    return counts, shapes


def cross_variant(files_a, files_b, num_classes: int):
    """C: the confusion matrix of variant b's maps (the prediction) against
    variant a's (the rows) over the views both have, and their number."""
    by_base = {os.path.basename(f): f for f in files_b}
    conf = np.zeros((num_classes, num_classes), np.int64)
    matched = 0
    for fa in files_a:
        fb = by_base.get(os.path.basename(fa))
        if fb is None:
            continue
        conf += confusion_matrix(load_label_map(fb), load_label_map(fa), num_classes)
        matched += 1
    return conf, matched


def pair_scores(conf: np.ndarray) -> dict:
    """A confusion matrix's pixel accuracy, per-class IoU, mIoU, class
    frequencies and frequency-weighted IoU, as scripts/parity_real.py reckons them."""
    iou = iou_per_class(conf)
    freq = conf.sum(axis=1) / max(conf.sum(), 1)
    return {"acc": float(np.trace(conf) / max(conf.sum(), 1)), "iou": iou,
            "miou": miou_from_confusion(conf), "freq": freq,
            "fwiou": float(np.nansum(np.where(np.isnan(iou), 0.0, iou) * freq))}


def main(argv=None):
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ref_root", required=True,
                   help="directory holding the semantics_*/train/labels/ variants")
    p.add_argument("--out", required=True, help="the report (markdown) to write")
    p.add_argument("--max_views", type=int, default=0,
                   help="0 = all views; >0 caps per-variant views (smoke runs)")
    args = p.parse_args(argv)

    variants = find_variants(args.ref_root)
    if not variants:
        raise SystemExit(f"no semantics_* label dirs under {args.ref_root}")
    if args.max_views > 0:
        variants = {k: v[: args.max_views] for k, v in variants.items()}
    C = len(OFFICESCENE_PROMPTS)

    lines = ["# Parity against the reference's label maps", "",
             f"Source: `{args.ref_root}/semantics_*/train/labels/*_labels.pt`, per-view "
             "label maps of the reference pipeline (render_semantics_logits.py:141-143) "
             f"at {REFERENCE_SHAPE[0]}x{REFERENCE_SHAPE[1]}, 13 classes "
             "(voxeltoGaussian_logits.sh prompts).", ""]

    lines += ["## A. Bit-exact load/save round-trip", ""]
    for name, files in variants.items():
        t0 = time.time()
        n = roundtrip_check(files)
        lines.append(f"- `{name}`: {n}/{len(files)} sampled files round-tripped "
                     f"EXACT (values+dtype+shape) in {time.time()-t0:.1f}s")
        print(lines[-1])
    lines.append("")

    lines += ["## B. Per-variant label histograms (pixel fraction per class)", ""]
    lines += ["| class | " + " | ".join(variants) + " |", "|---|" + "---|" * len(variants)]
    hists = {}
    for name, files in variants.items():
        counts, shapes = histogram(files, C)
        hists[name] = counts
        if shapes != {REFERENCE_SHAPE} and not args.max_views:
            raise ValueError(f"{name}: unexpected shapes {shapes}")
    for cid, prompt in enumerate(OFFICESCENE_PROMPTS):
        row = [f"{hists[n][cid] / max(hists[n].sum(), 1):.4f}" for n in variants]
        lines.append(f"| {cid} {prompt} | " + " | ".join(row) + " |")
    lines.append("")
    for name, files in variants.items():
        lines.append(f"- `{name}`: {len(files)} views, "
                     f"{int(hists[name].sum()):,} labelled pixels")
    lines.append("")

    lines += ["## C. Cross-variant mIoU (full eval protocol)", "",
              "Same scene and views, different reference voxel grids: how much the",
              "reference's own output moves with the grid.",
              "", "| pair | views | pixel acc | mIoU | fwIoU |", "|---|---|---|---|---|"]
    names = list(variants)
    per_class_blocks = []
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = names[i], names[j]
            conf, matched = cross_variant(variants[a], variants[b], C)
            s = pair_scores(conf)
            lines.append(f"| {a} vs {b} | {matched} | {s['acc']:.4f} | {s['miou']:.4f} "
                         f"| {s['fwiou']:.4f} |")
            print(lines[-1])
            blk = [f"### {a} vs {b} — per-class IoU", ""]
            for cid in range(C):
                if not np.isnan(s["iou"][cid]):
                    blk.append(f"- {OFFICESCENE_PROMPTS[cid]:10s} "
                               f"IoU {s['iou'][cid]:.4f}  freq {s['freq'][cid]:.4f}")
            per_class_blocks.append("\n".join(blk))
    lines.append("")
    lines += per_class_blocks
    lines += ["", "Produced by `python -m segsplat_tpu_torch.parity_real`."]

    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
