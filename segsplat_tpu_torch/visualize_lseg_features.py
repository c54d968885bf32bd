#!/usr/bin/env python
"""LSeg feature visualization, the twin of the repo's
scripts/visualize_lseg_features.py with the same flags (the reference's
script/visualize_lseg_features.py): each [C, H, W] feature map projected on
its top-3 principal axes into an RGB PNG, optionally blended over its source
image (the _overlay.sh variant). Host numpy, no ``--device``.

    python -m segsplat_tpu_torch.visualize_lseg_features --features FEATS \\
        --out_dir OUT [--images IMAGES --alpha 0.6]
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

import numpy as np
from PIL import Image


def pca_rgb(feats: np.ndarray) -> np.ndarray:
    """[C,H,W] → [H,W,3] uint8 via the top-3 PCA components."""
    C, H, W = feats.shape
    x = feats.reshape(C, -1).T.astype(np.float64)
    x = x - x.mean(axis=0)
    # top-3 principal axes via covariance eigendecomposition (C×C)
    cov = (x.T @ x) / max(len(x) - 1, 1)
    _, vecs = np.linalg.eigh(cov)
    proj = x @ vecs[:, -3:]
    lo, hi = np.percentile(proj, 2, axis=0), np.percentile(proj, 98, axis=0)
    rgb = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return (rgb.reshape(H, W, 3) * 255).astype(np.uint8)


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--features", required=True, help=".npy dir or single file")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--images", default="", help="overlay source image dir")
    p.add_argument("--alpha", type=float, default=0.6)
    args = p.parse_args(argv)

    files = ([args.features] if args.features.endswith(".npy")
             else sorted(glob.glob(os.path.join(args.features, "*.npy"))))
    if not files:
        raise SystemExit("no feature files found")
    os.makedirs(args.out_dir, exist_ok=True)
    for f in files:
        rgb = pca_rgb(np.load(f).astype(np.float32))
        name = os.path.splitext(os.path.basename(f))[0]
        Image.fromarray(rgb).save(os.path.join(args.out_dir, name + "_pca.png"))
        if args.images:
            for ext in (".jpg", ".png", ".jpeg", ".JPG"):
                ip = os.path.join(args.images, name + ext)
                if os.path.exists(ip):
                    img = np.asarray(Image.open(ip).convert("RGB").resize(
                        (rgb.shape[1], rgb.shape[0])), np.float32)
                    mix = args.alpha * rgb + (1 - args.alpha) * img
                    Image.fromarray(mix.astype(np.uint8)).save(
                        os.path.join(args.out_dir, name + "_overlay.png"))
                    break
        print(f"[OK] {name}")


if __name__ == "__main__":
    main()
