"""Unified-Lift training orchestration (the counterpart of
segsplat_tpu/pipeline/train.py, after the reference's
train_unified_lift.py:287-586): the host-side schedule around the train step.

  * random camera order per epoch (numpy ``default_rng(seed)``, as the JAX
    package draws it),
  * SH-degree bump every ``sh_up_every`` iterations,
  * densify / prune every ``densification_interval`` inside
    (densify_from_iter, densify_until_iter), with the changed rows' Adam moments
    zeroed,
  * opacity reset every ``opacity_reset_interval`` inside the densify window,
    zeroing only the opacity group's moments,
  * eval (L1 + PSNR) at test iterations, ``point_cloud.ply`` + ``classifier.npz``
    at save iterations, and resumable checkpoints (``torch.save`` of the table,
    both optimizers' state, codebook, densify stats and step) at checkpoint
    iterations,
  * metrics to ``metrics.jsonl``, and to wandb where ``SEGSPLAT_WANDB=1``
    and wandb imports (``_maybe_init_wandb``),
  * the SIBR viewer (``gui``, a ``viewer.NetworkGUI``) polled at the top of
    each iteration,
  * ``view_batch`` > 1: B views a step (parallel/train.py), split over the
    view ranks of a ``torch.distributed`` launch (one process a device, e.g.
    ``torchrun``) or rendered in turn on one device; ``mesh_tensor`` splits
    the codebook logits over that many ranks. Every rank draws the same camera
    order and densify draws, and only world rank 0 writes.

Stated limits: the process group's world must equal the mesh (view ×
tensor): a launch with idle ranks raises ValueError, where the JAX package
takes the first devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from segsplat_tpu_torch.core.types import stack_cameras
from segsplat_tpu_torch.eval.metrics import psnr_np
from segsplat_tpu_torch.io.dataset import resolution_scale_for
from segsplat_tpu_torch.ops.rasterize import tile_depth_counts
from segsplat_tpu_torch.parallel.mesh import Mesh, make_mesh
from segsplat_tpu_torch.parallel.train import make_parallel_train_step, replicate_state
from segsplat_tpu_torch.render import render
from segsplat_tpu_torch.scene import Scene, to_device_camera
from segsplat_tpu_torch.train.densify import (PARAM_FIELDS, DensifyStats,
                                              densify_and_prune, reset_opacity,
                                              zero_adam_rows)
from segsplat_tpu_torch.train.trainer import (OptimizationConfig, TrainState,
                                              init_state, make_train_step,
                                              one_up_sh_degree)
from segsplat_tpu_torch.utils.system import mkdir_p, require_device


@dataclasses.dataclass
class TrainRunConfig:
    iterations: int = 30_000
    test_iterations: tuple = (7_000, 30_000)
    save_iterations: tuple = (7_000, 30_000)
    checkpoint_iterations: tuple = (30_000,)
    white_background: bool = False
    resolution: int = -1
    num_classes: int = 256
    sh_up_every: int = 1_000
    log_every: int = 10
    seed: int = 0
    raster_max_tiles_per_axis: int = 8
    raster_max_per_tile: int = 256  # 0 → auto-size from the measured per-tile
    #                                 pair depth
    raster_tile_chunk: int = 64     # tiles per chunk of the dense blend
    raster_backend: str = "cuda"    # "cuda" (the blend kernels, at any K) or
    #                                 "dense" (torch ops)
    raster_pair_cap: int = 0        # >0: cap sorted raster pairs (num_pairs is
    #                                 logged, overflow warns)
    view_batch: int = 1             # views per iteration; >1 → the B-view step,
    #                                 split over the view ranks
    mesh_tensor: int = 1            # tensor-axis size for the codebook logits
    mesh_view: int = 0              # view-axis size (0 = auto: the largest
    #                                 divisor of view_batch ≤ world/mesh_tensor)


def _resolve_auto_max_per_tile(scene, table, run, device, n_probe: int = 3,
                               coverage: float = 0.995, densify_margin: float = 2.0,
                               lo: int = 256, hi: int = 4096) -> int:
    """Per-tile blend K from measured binning statistics: the smallest K that
    keeps ``coverage`` of the pairs of ``n_probe`` training views of the
    initial table, times ``densify_margin``, rounded up to 128 and clipped to
    [lo, hi]."""
    cams = scene.get_train_cameras()
    if not cams:
        return lo
    scale = resolution_scale_for(cams[0].width, cams[0].height, run.resolution)
    idx = np.unique(np.linspace(0, len(cams) - 1, min(n_probe, len(cams))).astype(int))
    k_needed = 1
    with torch.no_grad():
        for i in idx:
            dc = to_device_camera(cams[i], scale, device=device)
            K = dc.intrinsics()
            counts = tile_depth_counts(
                table.xyz, table.get_scaling(), table.get_rotation(),
                dc.world_view_transform(), K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                dc.width, dc.height, run.raster_max_tiles_per_axis).cpu().numpy()
            total = int(counts.sum())
            if total == 0:
                continue
            ks = np.unique(counts)
            kept = np.minimum(counts[None, :], ks[:, None]).sum(axis=1)
            k_needed = max(k_needed, int(ks[np.searchsorted(kept, coverage * total)]))
    cap = int(np.ceil(k_needed * densify_margin / 128.0)) * 128
    return int(min(max(cap, lo), hi))


def raster_kw_for(run: TrainRunConfig) -> dict:
    """The rasterizer's keyword arguments for ``run``; ``pair_cap`` applies to
    the kernel backend only. The kernels blend any K, so the port has no
    counterpart of the JAX package's ``"auto"``, which picks ``"xla"`` where K
    is no multiple of 128."""
    backend = run.raster_backend
    if backend not in ("cuda", "dense"):
        raise ValueError(f"raster_backend must be 'cuda' or 'dense', got {backend!r}")
    raster_kw = dict(max_tiles_per_axis=run.raster_max_tiles_per_axis,
                     max_per_tile=run.raster_max_per_tile,
                     tile_chunk=run.raster_tile_chunk, backend=backend)
    if run.raster_pair_cap and backend == "cuda":
        raster_kw["pair_cap"] = run.raster_pair_cap
    return raster_kw


def _train_mesh(run: TrainRunConfig) -> Optional[Mesh]:
    """The (view, tensor) mesh of ``run`` over the default process group, or
    None for single-view steps on one device. ``n_view`` is ``mesh_view``, or
    else the largest divisor of ``view_batch`` that is ≤ world/mesh_tensor.
    Raises ValueError when the mesh does not cover the world, or when the
    batch does not split over it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if run.view_batch <= 1 and run.mesh_tensor <= 1 and run.mesh_view <= 1 and world == 1:
        return None
    n_view = run.mesh_view or max(
        [d for d in range(1, world // run.mesh_tensor + 1) if run.view_batch % d == 0],
        default=1)
    if run.view_batch % n_view:
        raise ValueError(f"view_batch {run.view_batch} does not split over "
                         f"mesh_view {n_view}")
    return make_mesh(n_view, run.mesh_tensor)


def train(source_path: str, model_path: str, opt: Optional[OptimizationConfig] = None,
          run: Optional[TrainRunConfig] = None, images: str = "images",
          object_dir: str = "object_mask", eval_split: bool = False,
          capacity: Optional[int] = None, start_checkpoint: Optional[str] = None,
          progress_cb=None, gui=None, device: str | torch.device = "cuda") -> TrainState:
    """Train on ``device`` (the card unless the caller asks for the CPU). In a
    ``torch.distributed`` launch every rank calls it alike (``device`` is
    then its own card, or the CPU under gloo).

    ``gui`` (a ``viewer.NetworkGUI``, or None) is polled at the top of each
    iteration, before the step; under torch.distributed only world rank 0
    passes one. While a client pauses training, rank 0 stays in the poll and
    the other ranks wait at the step's next all-reduce, as in the JAX
    package; there is no timeout. ``train`` closes the gui when its loop ends,
    however it ends."""
    device = require_device(device)
    opt = opt or OptimizationConfig()
    run = run or TrainRunConfig()
    if run.num_classes != opt.num_classes:
        opt = dataclasses.replace(opt, num_classes=run.num_classes)
    mesh = _train_mesh(run)
    writer = mesh is None or mesh.is_rank0

    scene = Scene(source_path, model_path if writer else "", images=images,
                  object_dir=object_dir, eval_split=eval_split, capacity=capacity,
                  seed=run.seed, device=device)
    if run.raster_max_per_tile <= 0:
        cap = _resolve_auto_max_per_tile(scene, scene.gaussians, run, device)
        print(f"[INFO] auto max_per_tile={cap} (probed per-tile pair depth "
              f"x densify margin; overflow warnings still surface)")
        run = dataclasses.replace(run, raster_max_per_tile=cap)
    raster_kw = raster_kw_for(run)
    step_fn = make_train_step(opt, raster_kw)
    state = init_state(scene.gaussians, opt, spatial_lr_scale=scene.cameras_extent,
                       seed=run.seed)
    parallel_step = None
    if mesh is not None:
        replicate_state(state, mesh)
        parallel_step = make_parallel_train_step(opt, mesh, raster_kw)
        print(f"[INFO] data-parallel training: view_batch={run.view_batch} "
              f"over mesh view={mesh.n_view} tensor={mesh.n_tensor}")
    if start_checkpoint:
        load_checkpoint(start_checkpoint, state, mesh)
        print(f"[INFO] resumed from {start_checkpoint} at step {state.step}")

    cams = scene.get_train_cameras()
    if not cams:
        raise RuntimeError("no training cameras")
    # GT images and masks stay in host memory; one view moves per step
    scale = resolution_scale_for(cams[0].width, cams[0].height, run.resolution)
    gt_images, gt_objs, device_cams = [], [], []
    for c in cams:
        img = c.load_image(scale)
        gt_images.append(torch.from_numpy(np.ascontiguousarray(np.transpose(img, (2, 0, 1)))))
        obj = c.load_objects(scale)
        gt_objs.append(torch.from_numpy(obj if obj is not None
                                        else np.zeros(img.shape[:2], np.int32)))
        device_cams.append(to_device_camera(c, scale, device=device))
    if parallel_step is not None and len({g.shape for g in gt_images}) > 1:
        print("[WARN] view_batch>1 requires uniform camera resolutions; "
              "falling back to single-view steps")
        parallel_step = None

    bg = torch.full((3,), 1.0 if run.white_background else 0.0, device=device)
    # every rank draws the same camera order, contrastive samples and densify
    # draws
    gen = torch.Generator(device=device).manual_seed(run.seed)
    rng_np = np.random.default_rng(run.seed)

    if writer:
        mkdir_p(model_path)
    wandb_run = _maybe_init_wandb(model_path) if writer else None
    order = rng_np.permutation(len(cams))
    cursor = 0
    batch_views = run.view_batch if parallel_step is not None else 1
    t_start = time.perf_counter()
    with (open(os.path.join(model_path, "metrics.jsonl"), "a") if writer
          else contextlib.nullcontext()) as metrics_f, \
            (contextlib.closing(gui) if gui is not None else contextlib.nullcontext()):
        for it in range(state.step + 1, run.iterations + 1):
            cis = []
            for _ in range(batch_views):
                if cursor >= len(order):
                    order = rng_np.permutation(len(cams))
                    cursor = 0
                cis.append(int(order[cursor]))
                cursor += 1

            if gui is not None:
                # SIBR viewer poll (train_unified_lift.py:319-332)
                gui.poll_and_render(state.table, True, source_path, bg=bg)

            if it % run.sh_up_every == 0:
                state.table = one_up_sh_degree(state.table)

            if parallel_step is not None:
                metrics = parallel_step(state, stack_cameras([device_cams[i] for i in cis]),
                                        [gt_images[i] for i in cis],
                                        [gt_objs[i] for i in cis], bg, generator=gen)
            else:
                ci = cis[0]
                metrics = step_fn(state, device_cams[ci], gt_images[ci].to(device),
                                  gt_objs[ci].to(device), bg, generator=gen)

            # densify inside the window, strict bounds as the reference
            if (opt.densify_from_iter < it < opt.densify_until_iter
                    and it % opt.densification_interval == 0):
                table, stats, changed, overflow = densify_and_prune(
                    state.table, state.stats, opt.densify_grad_threshold,
                    opt.min_opacity, scene.cameras_extent, opt.percent_dense,
                    max_screen_size_on=(it > opt.opacity_reset_interval), generator=gen)
                zero_adam_rows(state.gauss_opt, changed)
                state.table, state.stats = table, stats
                if int(overflow) > 0:
                    print(f"[WARN] densify overflow: {int(overflow)} children "
                          f"dropped (capacity {state.table.capacity})")

            # the opacity reset lives inside the densification window too
            if it < opt.densify_until_iter and (
                    it % opt.opacity_reset_interval == 0 or
                    (run.white_background and it == opt.densify_from_iter)):
                state.table, changed = reset_opacity(state.table)
                zero_adam_rows(state.gauss_opt, changed, fields=("opacity",))

            if it % run.log_every == 0:
                rec = {"iter": it, **{k: float(v) for k, v in metrics.items()},
                       "num_gaussians": int(state.table.active.sum()),
                       "elapsed_s": time.perf_counter() - t_start}
                cap = raster_kw.get("pair_cap")
                if cap and rec["num_pairs"] > cap:
                    print(f"[WARN] raster pair_cap {cap} < real pairs "
                          f"{int(rec['num_pairs'])} at iter {it} — deepest pairs "
                          f"(and their gradients) are being dropped; raise --pair_cap")
                if rec["tile_overflow"] > 0:
                    print(f"[WARN] {int(rec['tile_overflow'])} pairs beyond the "
                          f"per-tile K cap at iter {it} — deepest Gaussians (and "
                          f"their gradients) in dense tiles are being dropped; "
                          f"raise max_per_tile")
                bad = [k for k, v in rec.items()
                       if isinstance(v, float) and not np.isfinite(v)]
                if bad:
                    _write_record(metrics_f, {**rec, "error": "non-finite"})
                    raise FloatingPointError(f"non-finite loss at iteration {it}: "
                                             f"{bad}; breakdown: {rec}")
                _write_record(metrics_f, rec)
                if wandb_run is not None:
                    wandb_run.log(rec, step=it)
                if progress_cb:
                    progress_cb(rec)

            if not writer:
                continue
            if it in run.test_iterations:
                rec = _evaluate(state.table, scene, scale, bg, raster_kw, it, device)
                _write_record(metrics_f, rec)
                print(f"[ITER {it}] eval: " + ", ".join(
                    f"{k}={v:.3f}" for k, v in rec.items() if isinstance(v, float)))

            if it in run.save_iterations:
                print(f"[ITER {it}] saving point cloud + classifier")
                scene.save(it, state.table)
                np.savez(os.path.join(model_path, "point_cloud", f"iteration_{it}",
                                      "classifier.npz"),
                         code_book=state.code_book.detach().cpu().numpy())
            if it in run.checkpoint_iterations:
                save_checkpoint(os.path.join(model_path, "chkpnts", f"chkpnt{it}.pt"),
                                state)
    return state


def _maybe_init_wandb(model_path: str):
    """Opt-in wandb logging (``SEGSPLAT_WANDB=1``; project from
    ``SEGSPLAT_WANDB_PROJECT``), as the JAX package's hook: the reference
    always logs to wandb (train_unified_lift.py:569-574); metrics.jsonl is
    written either way. Training goes on without wandb where it cannot
    start, with a warning."""
    if os.environ.get("SEGSPLAT_WANDB") != "1":
        return None
    try:
        import wandb

        return wandb.init(project=os.environ.get("SEGSPLAT_WANDB_PROJECT", "segsplat_tpu"),
                          name=os.path.basename(model_path) or None)
    except Exception as e:      # the boundary: a logging service must not stop training
        print(f"[WARN] wandb unavailable ({e}); metrics.jsonl only")
        return None


def _write_record(metrics_f, rec: dict) -> None:
    """One metrics.jsonl line; ranks other than 0 have no file."""
    if metrics_f is not None:
        metrics_f.write(json.dumps(rec) + "\n")
        metrics_f.flush()


@torch.no_grad()
def _evaluate(table, scene, scale, bg, raster_kw, it, device) -> dict:
    """Test-time L1 + PSNR over the held-out split, or the first 5 training
    views when there is none (the reference's training_report)."""
    cams = scene.get_test_cameras()
    split = "test"
    if not cams:
        cams = scene.get_train_cameras()[:5]
        split = "train"
    psnrs, l1s = [], []
    for c in cams:
        out = render(table, to_device_camera(c, scale, device=device), bg, **raster_kw)
        img = np.clip(out["render"].cpu().numpy(), 0, 1)
        gt = np.transpose(c.load_image(scale), (2, 0, 1))
        psnrs.append(psnr_np(img, gt))
        l1s.append(float(np.abs(img - gt).mean()))
    return {"iter": it, "eval_split": split, "eval_psnr": float(np.mean(psnrs)),
            "eval_l1": float(np.mean(l1s)), "eval_views": len(cams)}


# ───────────────────────────── checkpoints ─────────────────────────────

def save_checkpoint(path: str, state: TrainState) -> None:
    """A resumable checkpoint: ``torch.save`` of the table, both optimizers'
    state, the codebook, the densify stats and the step."""
    mkdir_p(os.path.dirname(path))
    t = state.table
    torch.save({
        "table": {f: getattr(t, f).detach() for f in PARAM_FIELDS},
        "active": t.active,
        "active_sh_degree": t.active_sh_degree,
        "code_book": state.code_book.detach(),
        "gauss_opt": state.gauss_opt.state_dict(),
        "cls_opt": state.cls_opt.state_dict(),
        "stats": tuple(state.stats),
        "step": state.step,
    }, path)


@torch.no_grad()
def load_checkpoint(path: str, state: TrainState, mesh: Optional[Mesh] = None) -> TrainState:
    """Restore a checkpoint of ``save_checkpoint`` into ``state`` in place (its
    tensors keep their identity, so its optimizers stay bound to them). Over a
    mesh with a process group, world rank 0 reads the file and broadcasts it."""
    dev = state.table.xyz.device
    if mesh is not None and mesh.groups is not None:
        box = [torch.load(path, map_location="cpu", weights_only=True)
               if mesh.is_rank0 else None]
        dist.broadcast_object_list(box, src=0)
        ck = box[0]
    else:
        ck = torch.load(path, map_location=dev, weights_only=True)
    for f in PARAM_FIELDS:
        getattr(state.table, f).copy_(ck["table"][f])
    state.table = dataclasses.replace(state.table, active=ck["active"].to(dev),
                                      active_sh_degree=int(ck["active_sh_degree"]))
    state.code_book.copy_(ck["code_book"])
    state.gauss_opt.load_state_dict(ck["gauss_opt"])
    state.cls_opt.load_state_dict(ck["cls_opt"])
    state.stats = DensifyStats(*(s.to(dev) for s in ck["stats"]))
    state.step = int(ck["step"])
    return state
