#!/usr/bin/env python
"""Semantic-assignment statistics, the twin of the repo's
scripts/analyze_gaussian_semantics.py with the same flags (the reference's
voxel_to_gaussian/semantics_stats/analyze_gaussian_semantics.py:10-60): label
histogram and per-label logit statistics of a gaussian_semantics .npz. Host
numpy, no ``--device``.

    python -m segsplat_tpu_torch.analyze_gaussian_semantics --semantics gaussian_semantics.npz
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.artifacts import load_semantics


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--semantics", required=True)
    args = p.parse_args(argv)

    d = load_semantics(args.semantics)
    labels, logits, prompts = d["labels"], d["logits"], [str(s) for s in d["prompts"]]
    total = len(labels)
    print(f"{total} gaussians, {len(prompts)} prompts")
    uniq, counts = np.unique(labels, return_counts=True)
    for u, c in sorted(zip(uniq.tolist(), counts.tolist()), key=lambda x: -x[1]):
        name = prompts[u] if u < len(prompts) else f"class{u}"
        sel = logits[labels == u]
        print(f"  {name:24s} {c:8d} ({100 * c / total:5.1f}%)  "
              f"logit mean={sel[:, u].mean():+.3f} max={sel[:, u].max():+.3f}")
    margins = np.sort(logits, axis=1)
    margin = margins[:, -1] - margins[:, -2] if logits.shape[1] > 1 else margins[:, -1]
    print(f"confidence margin: mean={margin.mean():.3f} p10="
          f"{np.percentile(margin, 10):.3f} p90={np.percentile(margin, 90):.3f}")


if __name__ == "__main__":
    main()
