#!/usr/bin/env python
"""Single-view feature projection, the twin of the repo's
scripts/project_features.py with the same flags plus ``--device`` (the
reference's kernel driver
cuda_project_image_to_sparse_voxel/debug_project_features.py:140-258): loads a
tensor_data .pt, runs the first-hit projection of each packed view on the
device, and writes proj_output.pt {projected_feats fp16 [N, C],
projected_indices (z, y, x) int64 [N, 3]} for the N voxels some pixel hit.

``--method splat`` (default) runs ops/lift_splat, ``dda`` the exact ray march
of ops/lift.

    python -m segsplat_tpu_torch.project_features --tensor_data tensor_data.pt \\
        --output proj_output.pt [--method splat|dda] [--device cuda|cpu]
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.ops.lift import default_max_steps, first_hit_voxels, scatter_features
from segsplat_tpu_torch.ops.lift_splat import first_hit_voxels_splat
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--tensor_data", required=True)
    p.add_argument("--output", default="proj_output.pt")
    p.add_argument("--depth_min", type=float, default=0.01)
    p.add_argument("--depth_max", type=float, default=10.0)
    p.add_argument("--method", default="splat", choices=["splat", "dda"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to project; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)

    td = torch.load(args.tensor_data, map_location="cpu", weights_only=False)
    feats = td["encoded_2d_features"][0]                  # [V, H, W, C]
    occ = td["occupancy_3D"].numpy().astype(np.int32)
    intr = td["intrinsicParams"][0].to(device)            # [V, 4]
    c2ws = td["viewMatrixInv"][0].to(device)              # [V, 4, 4]
    origin = np.asarray(td["grid_origin"], np.float32)
    vs = float(td["voxel_size"])
    f32 = dict(dtype=torch.float32, device=device)
    vs_t, inc_t = torch.tensor(vs, **f32), torch.tensor(vs * 0.5, **f32)

    V, H, W, C = feats.shape
    num_ids = int(occ.max()) + 1
    # reverse map id → (z, y, x) (debug_project_features.py:33-46)
    zyx = np.zeros((num_ids, 3), np.int64)
    nz = np.argwhere(occ > 0)
    ids = occ[nz[:, 0], nz[:, 1], nz[:, 2]]
    zyx[ids] = nz
    centers = torch.as_tensor(nz[:, ::-1].astype(np.float32) * vs + origin, device=device)
    ids = torch.as_tensor(ids, device=device)
    occ_t, origin_t = torch.as_tensor(occ, device=device), torch.as_tensor(origin, device=device)

    sums = torch.zeros((num_ids, C), **f32)
    counts = torch.zeros((num_ids,), dtype=torch.int32, device=device)
    for v in range(V):
        if args.method == "splat":
            hits = first_hit_voxels_splat(centers, ids, c2ws[v], intr[v], vs_t,
                                          args.depth_min, args.depth_max, inc_t, W, H)
        else:
            iv = [float(x) for x in intr[v].cpu()]
            steps = default_max_steps(W, H, iv[0], iv[1], args.depth_min, args.depth_max,
                                      vs * 0.5, cx=iv[2], cy=iv[3])
            hits = first_hit_voxels(occ_t, c2ws[v], intr[v], origin_t, vs_t, args.depth_min,
                                    args.depth_max, inc_t, W, H, steps)
        s, c = scatter_features(feats[v].to(device), hits, num_ids)
        sums, counts = sums + s, counts + c

    s = sums.cpu().numpy()
    c = counts.cpu().numpy()
    hit = np.flatnonzero(c[1:] > 0) + 1
    mean = s[hit] / c[hit, None]
    out = {"projected_feats": torch.from_numpy(mean.astype(np.float16)),
           "projected_indices": torch.from_numpy(zyx[hit])}
    torch.save(out, args.output)
    print(f"[DONE] {len(hit)} voxels hit ({int(c.sum())} pixel hits) → {args.output}")
    return out


if __name__ == "__main__":
    main()
