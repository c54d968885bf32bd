#!/usr/bin/env python
"""Voxel-level open-vocabulary query, the twin of the repo's
scripts/voxeltovoxel_logits.py with the same flags plus ``--device`` (the
reference's voxel_to_gaussian/voxeltovoxel_logits.py:138-291): labels stay on
the voxels, no Gaussian map.

    python -m segsplat_tpu_torch.voxeltovoxel_logits --vox VOX.pt --prompt wall chair \\
        --out voxel_semantics.npz [--device cuda|cpu]
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.pipeline.query import query_voxels


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--vox", required=True)
    p.add_argument("--prompt", type=str, nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--allow_random_weights", action="store_true",
                   help="accept voxel features tainted weights_source=random")
    p.add_argument("--require_provenance", action="store_true",
                   help="strict mode: also reject UNSTAMPED voxel features")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to score the voxels; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    out = query_voxels(args.vox, args.prompt, args.out,
                       allow_random_weights=args.allow_random_weights,
                       require_provenance=args.require_provenance, device=args.device)
    labels = out["labels"]
    print("[INFO] label histogram:",
          dict(zip(*[x.tolist() for x in np.unique(labels, return_counts=True)])))
    return out


if __name__ == "__main__":
    main()
