"""Unified-Lift training CLI on PyTorch/CUDA — the twin of the repo's train.py,
with the same flags plus ``--device``:

    python -m segsplat_tpu_torch.train -s DATA -m OUT [--capacity N] [--device cuda]

On several cards, one process a card:

    torchrun --nproc_per_node N -m segsplat_tpu_torch.train --view_batch B -s DATA -m OUT

``--view_batch`` B > 1 trains on B views a step. Under torchrun they split
over the ranks: ``--mesh_tensor`` T ranks split the codebook logits, the view
axis is the largest divisor of B that is at most N/T, and the mesh must use
all N ranks. On one card the B views render in turn. Under torchrun the CLI
joins the process group (NCCL, or gloo with ``--device cpu``) and only rank 0
writes.

``--ip``/``--port`` (default 6009; 0 turns it off) serve the SIBR viewer from
world rank 0 while training (``viewer.NetworkGUI``); a port that cannot be
bound warns and trains without it. ``--use_wandb`` is accepted and ignored, as
in the JAX package's CLI: wandb is opted into with ``SEGSPLAT_WANDB=1``.
"""

from __future__ import annotations

from argparse import ArgumentParser

import torch.distributed as dist

from segsplat_tpu_torch.parallel import multihost
from segsplat_tpu_torch.pipeline.train import TrainRunConfig, train
from segsplat_tpu_torch.train.trainer import OptimizationConfig
from segsplat_tpu_torch.utils.config import (ModelParams, OptimizationParams,
                                             PipelineParams, load_json_config,
                                             save_cfg_args)
from segsplat_tpu_torch.utils.system import require_device, safe_state
from segsplat_tpu_torch.viewer import NetworkGUI


def main(argv=None):
    parser = ArgumentParser(prog="python -m segsplat_tpu_torch.train",
                            description="Unified-Lift training on PyTorch/CUDA")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    PipelineParams(parser)
    parser.add_argument("--config_file", type=str, default="")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009,
                        help="SIBR viewer port (0: no viewer)")
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
                        help="views per iteration; >1 shards the batch over all "
                             "ranks of the launch (data parallelism)")
    parser.add_argument("--mesh_tensor", type=int, default=1,
                        help="tensor-parallel mesh axis for the codebook")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to train; cuda raises when no GPU is present")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    if args.config_file:
        load_json_config(args.config_file, args)
    device = require_device(args.device)
    joined = not dist.is_initialized() and multihost.launched_by_torchrun()
    if joined:
        multihost.initialize(backend="gloo" if device.type == "cpu" else "nccl")
    try:
        return _train(args, lp, op, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, lp, op, device):
    safe_state(args.quiet)
    dataset = lp.extract(args)
    opt_args = op.extract(args)
    if not dist.is_initialized() or dist.get_rank() == 0:
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
    gui = None
    if args.port > 0 and (not dist.is_initialized() or dist.get_rank() == 0):
        gui = NetworkGUI()
        try:
            gui.init(args.ip, args.port)
            print(f"GUI server at {args.ip}:{args.port}")
        except OSError as e:
            print(f"[WARN] viewer port unavailable ({e}); GUI disabled")
            gui = None

    print(f"Optimizing {dataset.model_path}")
    state = train(dataset.source_path, dataset.model_path, opt=opt, run=run,
                  images=dataset.images, object_dir=dataset.object_path,
                  eval_split=dataset.eval, capacity=args.capacity or None,
                  start_checkpoint=args.start_checkpoint, gui=gui, device=device)
    print("\nTraining complete.")
    return state
