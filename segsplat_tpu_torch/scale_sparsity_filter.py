#!/usr/bin/env python
"""Gaussian pre-filter by scale range and spikiness, the twin of the repo's
scripts/scale_sparsity_filter.py with the same flags (the reference's
betterGaussians/scale_sparsity_filter.py:16-50). Host numpy, no ``--device``.

    python -m segsplat_tpu_torch.scale_sparsity_filter --ply point_cloud.ply --out kept.ply
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.ply import read_ply, write_ply


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--ply", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--min_scale", type=float, default=-10.0)
    p.add_argument("--max_scale", type=float, default=10.0)
    p.add_argument("--spikiness_threshold", type=float, default=10.0)
    args = p.parse_args(argv)

    v = read_ply(args.ply).vertex
    scales = np.stack([v[f"scale_{i}"] for i in range(3)], axis=1)
    sc = np.clip(scales, 1e-6, None)
    mean_s = scales.mean(axis=1)
    mask = ((mean_s >= args.min_scale) & (mean_s <= args.max_scale)
            & ((sc.max(axis=1) / sc.min(axis=1)) < args.spikiness_threshold))
    write_ply(args.out, v[mask], binary=True)
    print(f"[DONE] kept {mask.sum()} / {len(v)} gaussians → {args.out}")
    return mask


if __name__ == "__main__":
    main()
