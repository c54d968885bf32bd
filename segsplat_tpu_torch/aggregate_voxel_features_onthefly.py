#!/usr/bin/env python
"""Multi-view 2D→3D feature aggregation CLI on PyTorch/CUDA, the twin of the
repo's aggregate_voxel_features_onthefly.py, with the same flags plus
``--device``:

    python -m segsplat_tpu_torch.aggregate_voxel_features_onthefly \\
        --voxel_ply GRID.ply --lseg_dir FEATURES --camera_params cameras.json \\
        [--out_dir OUT] [--method splat|dda] [--device cuda|cpu]

On several cards, one process a card, each view chunk split over the ranks:

    torchrun --nproc_per_node N -m segsplat_tpu_torch.aggregate_voxel_features_onthefly \
        ... --mesh_view N

``--mesh_view`` 0 means the world size of the launch, and any other value
must equal it; a world of one takes the single-device path. Under torchrun
the CLI joins the process group (NCCL, or gloo with ``--device cpu``), and
only rank 0 writes.
"""

from __future__ import annotations

from argparse import ArgumentParser

import torch.distributed as dist

from segsplat_tpu_torch.parallel import multihost
from segsplat_tpu_torch.parallel.mesh import make_mesh
from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, aggregate_voxel_features


def main(argv=None) -> dict:
    p = ArgumentParser(description="Lift LSeg feature maps into a sparse voxel grid")
    p.add_argument("--voxel_ply", required=True,
                   help="voxel-grid PLY with voxel_size/grid_origin header comments")
    p.add_argument("--lseg_dir", required=True,
                   help="directory of per-image [C,H,W] .npy feature maps")
    p.add_argument("--camera_params", required=True,
                   help="COLMAP-derived camera params JSON")
    p.add_argument("--out_dir", default="output/voxel_features")
    p.add_argument("--depth_min", type=float, default=0.01)
    p.add_argument("--depth_max", type=float, default=10.0)
    p.add_argument("--downsample_factor", type=float, default=0.5)
    p.add_argument("--max_views", type=int, default=216)
    p.add_argument("--checkpoint_every", type=int, default=20)
    p.add_argument("--view_chunk", type=int, default=8)
    p.add_argument("--image_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--first_only", action="store_true",
                   help="only process the first view (debug)")
    p.add_argument("--method", default="splat", choices=["splat", "dda"],
                   help="splat = fast voxel-splatting first hit; dda = exact "
                        "CUDA-kernel transcription")
    p.add_argument("--mesh_view", type=int, default=0,
                   help="shard each view chunk over N ranks (0 = the world size "
                        "of the launch; any other value must equal it)")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="accept a feature dir stamped weights_source=random "
                        "(taint propagates into the output artifacts)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) raises when no card is present")
    args = p.parse_args(argv)
    joined = not dist.is_initialized() and multihost.launched_by_torchrun()
    if joined:
        multihost.initialize(backend="gloo" if args.device == "cpu" else "nccl")
    try:
        return _lift(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _lift(args) -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_view = args.mesh_view or world
    if n_view != world:
        raise ValueError(f"--mesh_view {n_view} must equal the world size {world} "
                         "of the launch (0 takes it)")
    mesh = None
    if n_view > 1:
        mesh = make_mesh(n_view=n_view, n_tensor=1)
        print(f"[INFO] sharding view chunks over {n_view} ranks")
    cfg = LiftConfig(depth_min=args.depth_min, depth_max=args.depth_max,
                     downsample_factor=args.downsample_factor,
                     max_views=args.max_views,
                     checkpoint_every=args.checkpoint_every,
                     view_chunk=args.view_chunk, method=args.method)
    out = aggregate_voxel_features(args.voxel_ply, args.lseg_dir,
                                   args.camera_params, args.out_dir, cfg,
                                   image_size=(tuple(args.image_size)
                                               if args.image_size else None),
                                   mesh=mesh, first_only=args.first_only,
                                   allow_random_weights=args.allow_random_weights,
                                   device=args.device)
    print(f"[DONE] {out['views_per_sec']:.2f} views/s")
    return out


if __name__ == "__main__":
    main()
