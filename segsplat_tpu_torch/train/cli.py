"""Unified-Lift training CLI on PyTorch/CUDA — the twin of the repo's train.py,
with the same flags plus ``--device``:

    python -m segsplat_tpu_torch.train -s DATA -m OUT [--capacity N] [--device cuda]

Stated limits: ``--port`` defaults to 0 here, and a port > 0 raises because the
viewer is not ported yet; ``--view_batch`` and ``--mesh_tensor`` above 1 raise
(``pipeline/train.train``); ``--use_wandb`` is accepted and ignored, as in the
JAX package's CLI.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

from segsplat_tpu_torch.pipeline.train import TrainRunConfig, train
from segsplat_tpu_torch.train.trainer import OptimizationConfig
from segsplat_tpu_torch.utils.config import (ModelParams, OptimizationParams,
                                             PipelineParams, save_cfg_args)
from segsplat_tpu_torch.utils.system import require_device, safe_state


def main(argv=None):
    parser = ArgumentParser(prog="python -m segsplat_tpu_torch.train",
                            description="Unified-Lift training on PyTorch/CUDA")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("--config_file", type=str, default="")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="viewer port; the viewer is not ported, so only 0 runs")
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[30_000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--num_classes", type=int, default=256)
    parser.add_argument("--capacity", type=int, default=0)
    parser.add_argument("--pair_cap", type=int, default=0,
                        help="cap sorted raster pairs (speed knob; num_pairs is "
                             "logged and overflow warns)")
    parser.add_argument("--max_per_tile", type=int, default=256,
                        help="per-tile blend K, any positive count (0 = auto-size "
                             "from the measured per-tile pair depth)")
    parser.add_argument("--view_batch", type=int, default=1,
                        help="views per iteration; only 1 is ported")
    parser.add_argument("--mesh_tensor", type=int, default=1,
                        help="tensor-parallel mesh axis; only 1 is ported")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to train; cuda raises when no GPU is present")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    if args.config_file:
        with open(args.config_file) as f:
            for k, v in json.load(f).items():
                setattr(args, k, v)
    if args.port > 0:
        raise NotImplementedError("the SIBR viewer (--port > 0) is not ported yet; "
                                  "run with --port 0")
    device = require_device(args.device)

    safe_state(args.quiet)
    dataset = lp.extract(args)
    opt_args = op.extract(args)
    save_cfg_args(args.model_path, dataset)
    opt = OptimizationConfig(
        iterations=opt_args.iterations,
        position_lr_init=opt_args.position_lr_init,
        position_lr_final=opt_args.position_lr_final,
        position_lr_delay_mult=opt_args.position_lr_delay_mult,
        position_lr_max_steps=opt_args.position_lr_max_steps,
        feature_lr=opt_args.feature_lr,
        opacity_lr=opt_args.opacity_lr,
        scaling_lr=opt_args.scaling_lr,
        rotation_lr=opt_args.rotation_lr,
        percent_dense=opt_args.percent_dense,
        lambda_dssim=opt_args.lambda_dssim,
        densification_interval=opt_args.densification_interval,
        opacity_reset_interval=opt_args.opacity_reset_interval,
        densify_from_iter=opt_args.densify_from_iter,
        densify_until_iter=opt_args.densify_until_iter,
        densify_grad_threshold=opt_args.densify_grad_threshold,
        num_classes=args.num_classes,
    )
    run = TrainRunConfig(
        iterations=opt.iterations,
        test_iterations=tuple(args.test_iterations),
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
        white_background=dataset.white_background,
        resolution=dataset.resolution,
        num_classes=args.num_classes,
        raster_pair_cap=args.pair_cap,
        raster_max_per_tile=args.max_per_tile,
        view_batch=args.view_batch,
        mesh_tensor=args.mesh_tensor,
    )
    print(f"Optimizing {dataset.model_path}")
    state = train(dataset.source_path, dataset.model_path, opt=opt, run=run,
                  images=dataset.images, object_dir=dataset.object_path,
                  eval_split=dataset.eval, capacity=args.capacity or None,
                  start_checkpoint=args.start_checkpoint, device=device)
    print("\nTraining complete.")
    return state
