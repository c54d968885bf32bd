#!/usr/bin/env python
"""One-command inference pipeline on PyTorch/CUDA, the twin of the repo's
run_pipeline.py: trained Gaussians → voxel grid → feature lift → 1-NN map →
open-vocabulary query → semantic novel views, every stage in process on
``--device`` (the card by default), with the same artifact files written
between stages, so that any stage can be re-run or swapped with another
run's outputs.

    python -m segsplat_tpu_torch.run_pipeline \\
        -s data/officescene -m output/officescene --iteration 30000 \\
        --lseg_dir data/officescene/lseg_features \\
        --camera_params data/officescene/camera_params.json \\
        --prompt wall floor chair table monitor [--device cuda|cpu]

Stage 2 refuses a feature directory stamped ``weights_source=random`` (as the
JAX pipeline does; the lift's ``allow_random_weights`` is not passed).
``--render_backend`` takes ``cuda`` (the blend kernels) or ``dense`` (torch
ops), the JAX script's ``pallas`` and ``xla``.
"""

from __future__ import annotations

import glob
import json
import os
import time
from argparse import ArgumentParser

from segsplat_tpu_torch import render_semantics_logits
from segsplat_tpu_torch.eval import parity
from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, aggregate_voxel_features
from segsplat_tpu_torch.pipeline.query import build_map, extract_gaussian_centers, query
from segsplat_tpu_torch.pipeline.voxel_grid import (GridFilterConfig, build_voxel_grid,
                                                    save_grid)
from segsplat_tpu_torch.render import BACKENDS
from segsplat_tpu_torch.utils.system import require_device, search_for_max_iteration


def main(argv=None) -> dict:
    """Run the stages; returns {"work_dir", "timing" (seconds per stage),
    "semantics", "voxel_features", "grid_ply"}."""
    p = ArgumentParser()
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--lseg_dir", required=True)
    p.add_argument("--camera_params", required=True)
    p.add_argument("--prompt", nargs="+", required=True)
    p.add_argument("--cell_size", type=float, default=0.04)
    p.add_argument("--opacity_threshold", type=float, default=0.5)
    p.add_argument("--density_eps", type=float, default=0.08)
    p.add_argument("--density_min_neighbors", type=int, default=4)
    p.add_argument("--work_dir", default="")
    p.add_argument("--max_views", type=int, default=216)
    p.add_argument("--view_chunk", type=int, default=8,
                   help="views per step of the lift's sweep")
    p.add_argument("--skip_render", action="store_true")
    p.add_argument("--render_views", type=int, default=0,
                   help="render only the first N train views (0 = all)")
    p.add_argument("--render_backend", default="cuda", choices=list(BACKENDS),
                   help="blend for stage 5: cuda (the kernels; their plain versions "
                        "with --device cpu) or dense (torch ops)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) raises when no card is present")
    p.add_argument("--parity_dir", default="",
                   help="directory of reference-produced artifacts "
                        "(ALL_nonzero_voxel_features*.pt, gaussian_semantics*.npz, "
                        "grid_*.ply) to diff this run's outputs against via "
                        "eval/parity.py; a failed diff exits nonzero")
    args = p.parse_args(argv)
    device = require_device(args.device)
    stage_t = {}

    it = args.iteration
    if it == -1:
        it = search_for_max_iteration(os.path.join(args.model_path, "point_cloud"))
    ply = os.path.join(args.model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    work = args.work_dir or os.path.join(args.model_path, "semantic_pipeline")
    os.makedirs(work, exist_ok=True)

    print(f"[1/5] voxel grid from {ply}")
    t0 = time.perf_counter()
    grid = build_voxel_grid(ply, GridFilterConfig(
        cell_size=args.cell_size, opacity_threshold=args.opacity_threshold,
        density_eps=args.density_eps, density_min_neighbors=args.density_min_neighbors,
        normal_consistency=1.0), advanced=True)
    grid_ply = os.path.join(work, f"grid_{grid['stats']['voxels']}vox.ply")
    save_grid(grid_ply, grid)
    stage_t["voxel_grid"] = time.perf_counter() - t0
    print(f"      {grid['stats']}")

    print("[2/5] multi-view feature lift")
    t0 = time.perf_counter()
    lift = aggregate_voxel_features(
        grid_ply, args.lseg_dir, args.camera_params, work,
        LiftConfig(max_views=args.max_views, view_chunk=args.view_chunk), device=device)
    # the path the lift reports: a glob over work_dir could pick up a stale
    # artifact of an earlier run with other grid parameters
    vox_pt = lift["artifact"]
    stage_t["lift"] = time.perf_counter() - t0

    print("[3/5] gaussian centers + 1-NN map")
    t0 = time.perf_counter()
    mu = os.path.join(work, "gaussian_mu.npy")
    extract_gaussian_centers(ply, mu)
    g2v = os.path.join(work, "gauss2voxel.npy")
    build_map(vox_pt, mu, g2v, device=device)
    stage_t["centers_map"] = time.perf_counter() - t0

    print(f"[4/5] open-vocab query: {args.prompt}")
    t0 = time.perf_counter()
    sem = os.path.join(work, "gaussian_semantics.npz")
    query(vox_pt, g2v, mu, args.prompt, sem, device=device)
    stage_t["query"] = time.perf_counter() - t0

    if not args.skip_render:
        print("[5/5] semantic novel-view rendering")
        t0 = time.perf_counter()
        render_semantics_logits.main(
            ["--model_path", args.model_path, "--source_path", args.source_path,
             "--iteration", str(it), "--semantics", sem, "--skip_test",
             "--backend", args.render_backend, "--device", args.device]
            + (["--max_views", str(args.render_views)] if args.render_views > 0 else []))
        stage_t["render"] = time.perf_counter() - t0

    if args.parity_dir and not _check_parity(args.parity_dir, vox_pt, sem, grid_ply):
        raise SystemExit("[PARITY] FAILED — see report above")
    print("[TIMING] " + json.dumps({k: round(v, 1) for k, v in stage_t.items()}))
    print(f"[DONE] artifacts in {work}")
    return {"work_dir": work, "timing": stage_t, "semantics": sem, "voxel_features": vox_pt,
            "grid_ply": grid_ply}


def _check_parity(parity_dir: str, vox_pt: str, sem: str, grid_ply: str) -> bool:
    """Diff this run's stage artifacts against artifacts of the same kind in
    ``parity_dir``."""
    def find(*patterns):
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(parity_dir, pat)))
            if hits:
                return hits[-1]
        return None

    checks = [
        ("voxel_features", vox_pt,
         find("ALL_nonzero*voxel_features*.pt", "*voxel_features*.pt",
              "*voxel_features*.npz"), parity.compare_voxel_features),
        ("semantics", sem, find("gaussian_semantics*.npz", "*semantics*.npz"),
         parity.compare_semantics),
        ("voxel_grid", grid_ply, find("grid_*.ply", "*grid*.ply"),
         parity.compare_voxel_grids),
    ]
    ok = True
    for kind, ours, theirs, fn in checks:
        if theirs is None:
            print(f"[PARITY] {kind}: no reference artifact in {parity_dir}, skipped")
            continue
        print(f"[PARITY] {kind}: {ours} vs {theirs}")
        for r in fn(ours, theirs):
            print("  " + r.line())
            ok &= r.ok
    return ok


if __name__ == "__main__":
    main()
