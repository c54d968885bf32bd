"""Score a mid-train point-cloud snapshot of a pseudo-label-loop run, the
port's twin of scripts/eval_hard_scene_checkpoint.py (the same flags, plus
``--device``):

    python -m segsplat_tpu_torch.eval_hard_scene_checkpoint ROOT --iteration N
        [--frames 30 --size 256 --n_objects 20 ...] [--device cuda|cpu]

``pseudo_label_loop --save_at N`` writes ``point_cloud/iteration_N/`` (the PLY
and ``classifier.npz``) during training. The synthetic scene is deterministic
given (seed, frames, size, n_objects, layout, textured), so the cameras and
the GT instance maps are made again bit for bit; the table and codebook are
reloaded, and the loop's evaluation runs on them: identity prediction (K1 on
the card, the dense blend on the CPU), grouped and strict 1-1 mIoU, the class
consolidation and the LERF protocol. It writes ``merge_debug_iter{N}.npz`` in
the run root, for ``eval_hard_scene_offline`` and ``tune_class_merge``.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from types import SimpleNamespace

import numpy as np
import torch

from segsplat_tpu_torch.eval_hard_scene_offline import rescore
from segsplat_tpu_torch.pseudo_label_loop import (build_objects, lerf_protocol_eval,
                                                  orbit_cameras, predict_identity_maps,
                                                  render_sweep)
from segsplat_tpu_torch.render import raster_backend
from segsplat_tpu_torch.scene import load_gaussian_table
from segsplat_tpu_torch.utils.system import require_device


def eval_checkpoint(root: str, iteration: int, frames: int, size: int, n_objects: int,
                    layout: str, textured: bool, seed: int, max_per_tile: int,
                    capacity: int, device: str | torch.device = "cuda") -> dict:
    """The loop's evaluation of the snapshot at ``iteration`` under ``root``
    on ``device``: ``rescore``'s keys, ``iteration`` and ``lerf``."""
    device = require_device(device)
    H = W = size
    g = build_objects(np.random.default_rng(seed), n_objects=n_objects, layout=layout,
                      textured=textured)
    Rs, ts, fx, fy = orbit_cameras(frames, H, W)
    _, gts = render_sweep(g, Rs, ts, fx, fy, H, W, max_per_tile=max_per_tile, device=device)

    it_dir = os.path.join(root, "model", "point_cloud", f"iteration_{iteration}")
    table = load_gaussian_table(os.path.join(it_dir, "point_cloud.ply"), capacity=capacity,
                                device=device)
    code_book = torch.as_tensor(np.load(os.path.join(it_dir, "classifier.npz"))["code_book"],
                                device=device)
    state = SimpleNamespace(table=table, code_book=code_book)
    raster_kw = dict(max_tiles_per_axis=6, max_per_tile=max_per_tile, tile_chunk=16,
                     backend=raster_backend(device))
    preds, _, logit_maps, alphas = predict_identity_maps(state, Rs, ts, fx, fy, H, W,
                                                         raster_kw, device=device)

    npz_path = os.path.join(root, f"merge_debug_iter{iteration}.npz")
    np.savez_compressed(npz_path,
                        objects_dc=table.objects_dc.reshape(table.capacity, -1).cpu().numpy(),
                        code_book=code_book.cpu().numpy(), xyz=table.xyz.cpu().numpy(),
                        active=table.active.cpu().numpy(),
                        preds=np.stack(preds), gts=np.stack(gts))

    result = rescore(npz_path, n_objects)
    result["iteration"] = iteration
    result["lerf"] = {k: round(v, 4) if isinstance(v, float) else v
                      for k, v in lerf_protocol_eval(logit_maps, gts, alphas, seed=seed,
                                                     n_objects=n_objects,
                                                     device=device).items()}
    return result


def main(argv=None) -> dict:
    p = ArgumentParser()
    p.add_argument("root", help="pseudo_label_loop run root")
    p.add_argument("--iteration", type=int, required=True)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--n_objects", type=int, default=20)
    p.add_argument("--layout", default="random")
    p.add_argument("--textured", action="store_true", default=True)
    p.add_argument("--no-textured", dest="textured", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_per_tile", type=int, default=512)
    p.add_argument("--capacity", type=int, default=8192)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render; cuda raises when no GPU is present")
    args = p.parse_args(argv)

    out = eval_checkpoint(args.root, args.iteration, args.frames, args.size, args.n_objects,
                          args.layout, args.textured, args.seed, args.max_per_tile,
                          args.capacity, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
