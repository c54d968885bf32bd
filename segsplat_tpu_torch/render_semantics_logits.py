#!/usr/bin/env python
"""Semantic novel-view rendering CLI on PyTorch/CUDA — the twin of the repo's
render_semantics_logits.py, with the same flags plus ``--device``.

    python -m segsplat_tpu_torch.render_semantics_logits \
        --model_path MODEL --semantics gaussian_semantics.npz [--device cuda]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from segsplat_tpu_torch.io.artifacts import load_semantics
from segsplat_tpu_torch.io.dataset import resolution_scale_for
from segsplat_tpu_torch.io.provenance import read_weights_source, write_provenance
from segsplat_tpu_torch.pipeline.render_semantics import (attach_logits_for_table,
                                                          render_semantic_views)
from segsplat_tpu_torch.render import BACKENDS
from segsplat_tpu_torch.scene import Scene, to_device_camera
from segsplat_tpu_torch.utils.config import ModelParams, PipelineParams, get_combined_args
from segsplat_tpu_torch.utils.system import require_device, safe_state


def main(argv=None):
    parser = ArgumentParser(description="Render per-Gaussian semantic logits")
    ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--semantics", required=True,
                        help="gaussian_semantics .npz from voxeltoGaussian query")
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--white_background_sem", action="store_true",
                        help="composite logits on 1s instead of 0s")
    parser.add_argument("--backend", default="cuda", choices=list(BACKENDS),
                        help="cuda: the blend kernels (their plain PyTorch versions "
                             "with --device cpu), the JAX CLI's pallas; dense: the "
                             "dense blend in torch ops, its xla")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to render; cuda raises when no GPU is present")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="accept semantics tainted weights_source=random")
    parser.add_argument("--max_views", type=int, default=0,
                        help="render only the first N views of each split (0 = all)")
    args = get_combined_args(parser, argv)
    device = require_device(args.device)
    safe_state(args.quiet)

    scene = Scene(args.source_path, args.model_path, images=args.images,
                  eval_split=args.eval, shuffle=False,
                  load_iteration=args.iteration, device=device)
    logits = attach_logits_for_table(scene.gaussians, args.semantics,
                                     allow_random_weights=args.allow_random_weights)
    prompts = [str(s) for s in load_semantics(args.semantics)["prompts"]]
    bg_value = 1.0 if args.white_background_sem else 0.0

    for split, cams in (("train", scene.get_train_cameras()),
                        ("test", scene.get_test_cameras())):
        if (split == "train" and args.skip_train) or \
           (split == "test" and args.skip_test) or not cams:
            continue
        scale = resolution_scale_for(cams[0].width, cams[0].height, args.resolution)
        if args.max_views > 0:
            cams = cams[:args.max_views]
        dcams = [to_device_camera(c, scale, device=device) for c in cams]
        out_dir = os.path.join(args.model_path, split, f"ours_{scene.loaded_iter}",
                               "semantics")
        ws = read_weights_source(args.semantics)
        if ws is not None:  # taint/lineage follows the rendered label maps
            write_provenance(out_dir, ws, stage="render_semantics")
        print(f"[INFO] rendering {len(dcams)} {split} views → {out_dir}")
        render_semantic_views(scene.gaussians, dcams, logits, out_dir,
                              prompts=prompts, bg_value=bg_value,
                              backend=args.backend)


if __name__ == "__main__":
    main()
