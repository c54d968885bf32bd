"""Offline sweep of the post-train codebook-class merge, the port's twin of
scripts/tune_class_merge.py (the same flags but the JAX-only ``--platform``;
everything here is host numpy):

    python -m segsplat_tpu_torch.tune_class_merge --npz RUN/merge_debug.npz --n_objects 20
        [--out_json rows.json]

Reads the ``merge_debug.npz`` a pseudo_label_loop run saves (trained identity
features, codebook, positions, rendered predictions, GT maps) and scores the
merge criteria of ``pipeline/consolidate.py`` over a grid of mix and feature
thresholds without training again, grouped and strict 1-1 mIoU each. GT is
used only to score, never inside a criterion.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser
from typing import Sequence

import numpy as np

from segsplat_tpu_torch.pipeline.consolidate import ClassMergeConfig, consolidate_classes
from segsplat_tpu_torch.pseudo_label_loop import match_miou

MIX_THRESHOLDS = (0.02, 0.04, 0.06, 0.08, 0.12)
FEAT_THRESHOLDS = (-1.0, 0.0, 0.3, 0.5, 0.8)


def score(preds, gts, n_pred, n_objects):
    """(grouped, strict 1-1) mIoU of the class maps against the GT maps."""
    grouped, _, strict, _ = match_miou(list(preds), list(gts), n_pred, n_objects=n_objects)
    return grouped, strict


def apply_remap(preds, remap):
    return [remap[p] for p in preds]


def sweep(npz: str, n_objects: int, mix_thresholds: Sequence[float] = MIX_THRESHOLDS,
          feat_thresholds: Sequence[float] = FEAT_THRESHOLDS) -> list:
    """The baseline row, then one row per (mix, feature) threshold pair whose
    merge differs from the last row's "no merge" (a run of unmerged pairs is
    scored once)."""
    d = np.load(npz)
    feat, cb, xyz, active = d["objects_dc"], d["code_book"], d["xyz"], d["active"]
    preds, gts = d["preds"], d["gts"]
    n_pred = cb.shape[0] + 1

    g0, s0 = score(preds, gts, n_pred, n_objects)
    print(f"baseline (no merge): grouped={g0:.4f} strict_1to1={s0:.4f}")
    rows = [{"criterion": "none", "grouped": g0, "strict": s0}]
    for mix_t in mix_thresholds:
        for feat_t in feat_thresholds:
            stats = {}
            remap = consolidate_classes(feat, cb, xyz, active=active,
                                        cfg=ClassMergeConfig(mix_threshold=mix_t,
                                                             feat_threshold=feat_t),
                                        stats=stats)
            merged = int((remap[1:] != np.arange(1, len(remap))).sum())
            if merged == 0 and rows and rows[-1].get("merged") == 0:
                continue
            g, s = score(apply_remap(preds, remap), gts, n_pred, n_objects)
            rows.append({"criterion": f"mix>={mix_t},cos>={feat_t}",
                         "grouped": round(g, 4), "strict": round(s, 4), "merged": merged,
                         "merge_pairs": stats.get("n_merge_pairs")})
            print(f"mix>={mix_t:.2f} cos>={feat_t:+.1f}: grouped={g:.4f} "
                  f"strict={s:.4f} merged_ids={merged}")
    return rows


def best_row(rows: list) -> dict:
    return max(rows, key=lambda r: (r["strict"], r["grouped"]))


def main(argv=None) -> list:
    p = ArgumentParser()
    p.add_argument("--npz", required=True)
    p.add_argument("--n_objects", type=int, required=True)
    p.add_argument("--out_json", default=None)
    args = p.parse_args(argv)

    rows = sweep(args.npz, args.n_objects)
    best = best_row(rows)
    print(f"[BEST] {json.dumps(best)}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"rows": rows, "best": best}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
