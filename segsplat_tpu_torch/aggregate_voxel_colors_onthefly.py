#!/usr/bin/env python
"""RGB aggregation sanity path, the twin of the repo's
scripts/aggregate_voxel_colors_onthefly.py with the same flags plus
``--device`` (the reference's
cuda_project_image_to_sparse_voxel/aggregate_voxel_colors_onthefly.py): lifts
image colours (in place of LSeg features) through the multi-view lift into
the voxel grid and writes a mean-colour PLY, the visual check that the
projection geometry is right.

    python -m segsplat_tpu_torch.aggregate_voxel_colors_onthefly --voxel_ply GRID.ply \\
        --images_dir IMAGES --camera_params cams.json [--device cuda|cpu]
"""

from __future__ import annotations

import glob
import os
import tempfile
from argparse import ArgumentParser

import numpy as np
from PIL import Image

from segsplat_tpu_torch.io.ply import write_voxel_grid_ply
from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, aggregate_voxel_features
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--voxel_ply", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--camera_params", required=True)
    p.add_argument("--out_dir", default="output/voxel_colors")
    p.add_argument("--downsample_factor", type=float, default=0.5)
    p.add_argument("--max_views", type=int, default=216)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to lift; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)

    # stage images as [3, H, W] .npy "feature" maps and reuse the lift pipeline
    with tempfile.TemporaryDirectory() as tmp:
        files = sorted(sum((glob.glob(os.path.join(args.images_dir, e))
                            for e in ("*.jpg", "*.png", "*.jpeg", "*.JPG")), []))[:args.max_views]
        if not files:
            raise SystemExit(f"no images in {args.images_dir}")
        for f in files:
            img = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
            name = os.path.splitext(os.path.basename(f))[0]
            np.save(os.path.join(tmp, name + ".npy"),
                    np.transpose(img, (2, 0, 1)).astype(np.float16))
        cfg = LiftConfig(downsample_factor=args.downsample_factor,
                         max_views=args.max_views, checkpoint_every=0)
        out = aggregate_voxel_features(args.voxel_ply, tmp, args.camera_params,
                                       args.out_dir, cfg, device=device)

    sums = out["sums"].cpu().numpy()[1:]
    counts = out["counts"].cpu().numpy()[1:]
    nz = counts > 0
    mean = np.zeros_like(sums)
    mean[nz] = sums[nz] / counts[nz, None]
    grid = out["grid"]
    cols = (np.clip(mean, 0, 1) * 255).astype(np.uint8)
    ply = os.path.join(args.out_dir, f"voxel_colors_{int(nz.sum())}hit.ply")
    write_voxel_grid_ply(ply, grid.centers().cpu().numpy(), cols, float(grid.voxel_size),
                         grid.origin.cpu().numpy())
    print(f"[DONE] {int(nz.sum())} voxels colored → {ply}")
    return ply


if __name__ == "__main__":
    main()
