#!/usr/bin/env python
"""Voxel→Gaussian open-vocabulary query CLI on PyTorch/CUDA, the twin of the
repo's voxeltoGaussian_logits.py (the reference's subcommands, :350-384), with
``--device`` on build_map and query:

    python -m segsplat_tpu_torch.voxeltoGaussian_logits convert --pt VOX.pt --out VOX.npz
    python -m segsplat_tpu_torch.voxeltoGaussian_logits build_map --vox VOX.pt \\
        --gauss point_cloud.ply --out gauss2voxel.npy [--device cuda|cpu]
    python -m segsplat_tpu_torch.voxeltoGaussian_logits query --vox VOX.pt \\
        --map gauss2voxel.npy --gauss point_cloud.ply --prompt wall chair \\
        --out gaussian_semantics.npz [--device cuda|cpu]
"""

from __future__ import annotations

import pathlib
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.pipeline import query as Q


def main(argv=None):
    p = ArgumentParser(description="voxel→Gaussian semantic transfer + CLIP query")
    sp = p.add_subparsers(dest="cmd", required=True)

    cvt = sp.add_parser("convert", help=".pt/.pth → .npz (voxels)")
    cvt.add_argument("--pt", type=pathlib.Path, required=True)
    cvt.add_argument("--out", type=pathlib.Path, required=True)

    bld = sp.add_parser("build_map", help="Gaussian → voxel 1-NN index map")
    bld.add_argument("--vox", type=pathlib.Path, required=True)
    bld.add_argument("--gauss", type=pathlib.Path, required=True)
    bld.add_argument("--out", type=pathlib.Path, required=True)
    bld.add_argument("--batch", type=int, default=200_000,
                     help="the reference KD-tree's batch, kept for argument compatibility: "
                          "only the default is taken (the device path runs in chunks of "
                          "4 096 centres)")
    bld.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="cuda (default) raises when no card is present")

    qry = sp.add_parser("query", help="Prompt → per-Gaussian labels")
    qry.add_argument("--vox", type=pathlib.Path, required=True)
    qry.add_argument("--map", type=pathlib.Path, required=True)
    qry.add_argument("--gauss", type=pathlib.Path, required=True)
    qry.add_argument("--prompt", type=str, nargs="+", required=True)
    qry.add_argument("--out", type=pathlib.Path, required=True)
    qry.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="cuda (default) raises when no card is present")
    qry.add_argument("--allow_random_weights", action="store_true",
                     help="accept voxel features tainted weights_source=random")
    qry.add_argument("--require_provenance", action="store_true",
                     help="strict mode: also reject UNSTAMPED voxel features")

    args = p.parse_args(argv)
    if args.cmd == "build_map" and args.batch != 200_000:
        p.error(f"--batch {args.batch}: the device path runs in chunks of 4 096 centres "
                "and takes no batch")
    if args.cmd == "convert":
        Q.convert_pt_to_npz(str(args.pt), str(args.out))
    elif args.cmd == "build_map":
        Q.build_map(str(args.vox), str(args.gauss), str(args.out), device=args.device)
    else:
        out = Q.query(str(args.vox), str(args.map), str(args.gauss), args.prompt,
                      str(args.out), allow_random_weights=args.allow_random_weights,
                      require_provenance=args.require_provenance, device=args.device)
        print("[INFO] label histogram:",
              dict(zip(*[x.tolist() for x in np.unique(out["labels"], return_counts=True)])))


if __name__ == "__main__":
    main()
