#!/usr/bin/env python
"""Single-view tensor-data packer, the twin of the repo's
scripts/prepare_tensor_data.py with the same flags plus ``--device`` (the
reference's cuda_project_image_to_sparse_voxel/prepare_tensor_data.py:100-199):
writes the tensor_data .pt contract ({encoded_2d_features [1,V,H,W,C],
occupancy_3D, intrinsicParams, viewMatrixInv, grid_origin, voxel_size}) that
``project_features`` reads. One intrinsics row per view, as the JAX script
(not the reference's double append). ``--image_size`` resizes each map on the
device with the lift's resize (``jax.image.resize``'s bilinear, antialiased).

    python -m segsplat_tpu_torch.prepare_tensor_data --lseg_dir FEATS \\
        --scaled_camera_params cams.json --occupancy occ.pt --voxel_size 0.04 \\
        --grid_origin X Y Z --output tensor_data.pt [--device cuda|cpu]
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.pipeline.lift_features import (camera_arrays_for, load_camera_json,
                                                        resize_features)
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--lseg_dir", required=True)
    p.add_argument("--scaled_camera_params", required=True)
    p.add_argument("--occupancy", required=True, help=".pt/.npz occupancy file")
    p.add_argument("--voxel_size", type=float, required=True)
    p.add_argument("--grid_origin", type=float, nargs=3, required=True)
    p.add_argument("--max_images", type=int, default=1)
    p.add_argument("--output", required=True)
    p.add_argument("--image_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--downsample_factor", type=float, default=1.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where --image_size resizes; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)

    files = sorted(glob.glob(os.path.join(args.lseg_dir, "*.npy")))[:args.max_images]
    name_to_entry, cam_params, _ = load_camera_json(args.scaled_camera_params)
    c2ws, intr, files = camera_arrays_for(files, name_to_entry, cam_params,
                                          args.downsample_factor)
    feats = []
    for f in files:
        arr = np.load(f).astype(np.float32)                     # [C, h, w]
        if args.image_size is not None:
            arr = resize_features(torch.as_tensor(arr, device=device),
                                  *args.image_size).cpu().numpy()
        feats.append(np.transpose(arr, (1, 2, 0)))              # [H, W, C]

    if args.occupancy.endswith(".pt"):
        occ = torch.load(args.occupancy, map_location="cpu", weights_only=False)
        occ = occ["occupancy_3D"] if isinstance(occ, dict) else occ
    else:
        occ = torch.from_numpy(np.load(args.occupancy)["occupancy_3D"])

    out = {
        "encoded_2d_features": torch.from_numpy(np.stack(feats)[None]),
        "occupancy_3D": occ,
        "intrinsicParams": torch.from_numpy(intr[None]),
        "viewMatrixInv": torch.from_numpy(c2ws[None]),
        "grid_origin": torch.tensor(args.grid_origin, dtype=torch.float32),
        "voxel_size": float(args.voxel_size),
    }
    torch.save(out, args.output)
    print(f"[DONE] {len(files)} view(s) → {args.output}")
    return out


if __name__ == "__main__":
    main()
