#!/usr/bin/env python
"""Checkpoint and statistics export tools, the twin of the repo's
scripts/export_gaussians.py with the same sub-commands and flags (the
reference's export_gaussians/ CLIs, export_gaussian.py:11-70):

    python -m segsplat_tpu_torch.export_gaussians stats --ply point_cloud.ply
    python -m segsplat_tpu_torch.export_gaussians count --ply point_cloud.ply
    python -m segsplat_tpu_torch.export_gaussians from_checkpoint \\
        --checkpoint MODEL/chkpnts/chkpnt30000.pt --out point_cloud.ply

``from_checkpoint`` reads the port's own checkpoint (the ``torch.save`` dict of
``pipeline/train.save_checkpoint``), not the JAX package's orbax directory,
and writes its active rows. Host only, no ``--device``.
"""

from __future__ import annotations

import math
from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.core.types import GaussianTable
from segsplat_tpu_torch.io.ply import read_ply
from segsplat_tpu_torch.scene import save_gaussian_table


def table_from_checkpoint(path: str) -> GaussianTable:
    """The Gaussian table of a ``save_checkpoint`` file, on the CPU."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    rest = ck["table"]["features_rest"].shape[1]
    return GaussianTable(**ck["table"], active=ck["active"],
                         active_sh_degree=int(ck["active_sh_degree"]),
                         max_sh_degree=math.isqrt(rest + 1) - 1)


def main(argv=None):
    p = ArgumentParser()
    sp = p.add_subparsers(dest="cmd", required=True)

    st = sp.add_parser("stats", help="print Gaussian PLY property statistics")
    st.add_argument("--ply", required=True)

    cnt = sp.add_parser("count", help="count points in a PLY")
    cnt.add_argument("--ply", required=True)

    ck = sp.add_parser("from_checkpoint", help="train checkpoint (.pt) → PLY")
    ck.add_argument("--checkpoint", required=True)
    ck.add_argument("--out", required=True)

    args = p.parse_args(argv)
    if args.cmd == "count":
        print(len(read_ply(args.ply).vertex))
    elif args.cmd == "stats":
        c = read_ply(args.ply)
        for name in c.names:
            v = np.asarray(c[name], np.float64)
            print(f"{name:16s} min={v.min():+.4f} max={v.max():+.4f} "
                  f"mean={v.mean():+.4f} std={v.std():.4f}")
        if "opacity" in c.names:
            op = 1 / (1 + np.exp(-np.asarray(c["opacity"], np.float64)))
            print(f"{'sigmoid(opacity)':16s} min={op.min():.4f} max={op.max():.4f} "
                  f"mean={op.mean():.4f}")
    else:
        save_gaussian_table(args.out, table_from_checkpoint(args.checkpoint))
        print(f"[DONE] → {args.out}")


if __name__ == "__main__":
    main()
