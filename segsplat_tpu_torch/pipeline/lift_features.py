"""Multi-view 2D→3D feature aggregation, stage 2 of run_pipeline.py (the
counterpart of segsplat_tpu/pipeline/lift_features.py, after the reference's
cuda_project_image_to_sparse_voxel/aggregate_voxel_features_onthefly.py).

  * the occupancy is built once (ops/voxelize.occupancy_from_grid: the round()
    snap and 1-based ids of build_sparse_occupancy.py),
  * view by view, the fp16 feature map goes to the device, is upcast and
    resized there (bilinear with half-pixel centres, antialiased when it
    shrinks, as ``jax.image.resize``; the reference's cv2.INTER_LINEAR per
    channel), lifted to its first-hit voxels (``method="splat"``,
    ops/lift_splat, or ``"dda"``, ops/lift) and summed into [V+1, C]
    accumulators in device memory, with the same bits on every run,
  * checkpoints whenever the views done cross a multiple of
    ``checkpoint_every``, and the final ``ALL_nonzero_voxel_features`` artifact,
    keep the reference's file contract ({xyz, avg_feats fp16, voxel_coords},
    aggregate…onthefly.py:379-453).

Camera conventions follow prepare_tensor_data.py:165-174: extrinsics arrive as
world→cam (R, tvec) and are inverted to cam→world [Rᵀ | -Rᵀt]; intrinsics
[fx, fy, cx, cy] are scaled by the downsample factor.

Left out of the port: the JAX package's ``mesh`` argument, which shards view
chunks over several devices (the multi-device slice), and its
``_device_put_bounded``, which works around a transfer limit of the TPU host.
The tail chunk of views is not padded, as the JAX package pads it with views
of zero c2w and intrinsics (1, 1, -1e9, 0). Its splat lift finds no voxel in
such a view, so the results are the same; its DDA turns their rays into NaN
directions that round to voxel (0, 0, 0), which gains H·W hits of zero
features per padded view where it is occupied. The port lifts only real views.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from segsplat_tpu_torch.core.types import VoxelGrid
from segsplat_tpu_torch.io.artifacts import load_feature_map, save_voxel_features
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply, write_voxel_grid_ply
from segsplat_tpu_torch.io.provenance import (read_weights_source, require_untainted,
                                              write_provenance)
from segsplat_tpu_torch.ops.lift import default_max_steps, first_hit_voxels, scatter_features
from segsplat_tpu_torch.ops.lift_splat import lift_view_splat
from segsplat_tpu_torch.ops.voxelize import occupancy_from_grid
from segsplat_tpu_torch.utils.system import require_device


@dataclasses.dataclass
class LiftConfig:
    depth_min: float = 0.01            # debug_project_features.py:164-170
    depth_max: float = 10.0
    ray_increment_factor: float = 0.5  # ray step = voxel_size * this
    downsample_factor: float = 0.5     # aggregate…onthefly.py:209
    max_views: int = 216               # :106
    checkpoint_every: int = 20         # :317
    view_chunk: int = 8                # views loaded per step of the sweep
    method: str = "splat"              # "splat" (ops/lift_splat) or "dda"
    #                                    (the kernel's exact transcription)
    splat_max_tiles_per_axis: int = 8
    splat_max_per_tile: int = 128
    splat_big_budget: int = 0          # dual-bin big-voxel budget (0 = V/8);
    #                                    overflow is surfaced as a [WARN]


def load_camera_json(path: str) -> Tuple[Dict[str, dict], Dict[str, list],
                                         Dict[str, Tuple[int, int]]]:
    """Parse the stage's camera-params JSON (COLMAP-derived): returns
    (name→{R, tvec, camera_id}, camera_id→[fx,fy,cx,cy], camera_id→(W,H) for
    entries that carry width/height). Accepts both the {"images": {...},
    "cameras": {...}} layout prepare_tensor_data.py reads and the flat
    {"cameras": [...]} layout the aggregator rescales."""
    with open(path) as f:
        data = json.load(f)
    name_to_entry: Dict[str, dict] = {}
    cam_params: Dict[str, list] = {}
    cam_sizes: Dict[str, Tuple[int, int]] = {}
    if isinstance(data.get("images"), dict):
        for _k, entry in data["images"].items():
            base = os.path.splitext(os.path.basename(entry["name"]))[0]
            name_to_entry[base] = entry
        for cid, cam in data.get("cameras", {}).items():
            p = cam["params"]
            cam_params[str(cid)] = ([p[0], p[0], p[1], p[2]] if len(p) == 3
                                    else list(p[:4]))
            if "width" in cam and "height" in cam:
                cam_sizes[str(cid)] = (int(cam["width"]), int(cam["height"]))
    else:
        for i, cam in enumerate(data.get("cameras", [])):
            name = os.path.splitext(os.path.basename(cam.get("name", f"cam{i}")))[0]
            entry = dict(cam)
            entry.setdefault("camera_id", str(i))
            name_to_entry[name] = entry
            if "intrinsic" in cam:
                cam_params[str(entry["camera_id"])] = list(cam["intrinsic"][:4])
            if "width" in cam and "height" in cam:
                cam_sizes[str(entry["camera_id"])] = (int(cam["width"]), int(cam["height"]))
    return name_to_entry, cam_params, cam_sizes


def camera_arrays_for(files: Sequence[str], name_to_entry, cam_params,
                      downsample: float) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Match feature files to cameras; build c2w [V,4,4] + intrinsics [V,4]."""
    c2ws, intr, kept = [], [], []
    for fpath in files:
        base = os.path.splitext(os.path.basename(fpath))[0]
        entry = name_to_entry.get(base)
        if entry is None:
            print(f"[WARN] No camera entry for feature file {base}, skipping")
            continue
        R = np.asarray(entry["R"], np.float32)
        t = np.asarray(entry["tvec"], np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        p = (np.asarray(cam_params[str(entry["camera_id"])], np.float32)
             if str(entry.get("camera_id")) in cam_params
             else np.asarray(entry["intrinsic"][:4], np.float32))
        c2ws.append(c2w)
        intr.append(p * downsample)
        kept.append(fpath)
    return (np.stack(c2ws) if c2ws else np.zeros((0, 4, 4), np.float32),
            np.stack(intr) if intr else np.zeros((0, 4), np.float32), kept)


@record_function("lift.resize")
def resize_features(fmap: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[C, h, w] → [C, height, width] float32, bilinear with half-pixel centres
    and a widened triangle filter when it shrinks: ``jax.image.resize(...,
    "bilinear")``, whose antialias is on by default."""
    return F.interpolate(fmap.to(torch.float32)[None], size=(height, width),
                         mode="bilinear", align_corners=False, antialias=True)[0]


def lift_grid(centers: np.ndarray, vs: float, origin: np.ndarray, shape, device):
    """What both lifts read of a grid PLY's (centres, voxel_size, grid_origin,
    grid_shape), on ``device``: (the VoxelGrid of round((c - origin)/vs), its
    dense occupancy with 1-based ids in input order, the occupancy's origin
    (numpy), the centres snapped to it for the splat lift, their ids)."""
    f32 = dict(dtype=torch.float32, device=device)
    grid = VoxelGrid(coords=torch.as_tensor(np.round((centers - origin) / vs).astype(np.int32),
                                            device=device),
                     origin=torch.as_tensor(origin, **f32),
                     voxel_size=torch.tensor(vs, **f32),
                     shape=shape if shape else ())
    occ, occ_origin, _ = occupancy_from_grid(grid)
    snap_centers = torch.as_tensor(np.round((centers - occ_origin) / vs) * vs + occ_origin,
                                   **f32)
    snap_ids = torch.arange(1, len(centers) + 1, dtype=torch.int32, device=device)
    return grid, occ, occ_origin, snap_centers, snap_ids


def aggregate_voxel_features(voxel_ply: str, lseg_dir: str, camera_params: str,
                             out_dir: str, cfg: LiftConfig = LiftConfig(),
                             image_size: Optional[Tuple[int, int]] = None,
                             first_only: bool = False,
                             allow_random_weights: bool = False,
                             device: str | torch.device = "cuda") -> dict:
    """Run the multi-view lift on ``device`` (the card unless the caller asks
    for the CPU); writes checkpoints and the final artifacts into ``out_dir``.
    Returns {"sums", "counts" (tensors on the device), "grid", "views_per_sec",
    "overflow" (the most slots any view truncated), "artifact" (final .pt path)}."""
    device = require_device(device)
    centers, _, vs, origin, shape = read_voxel_grid_ply(voxel_ply)
    if vs is None:
        raise RuntimeError(f"{voxel_ply}: missing voxel_size header comment")
    f32 = dict(dtype=torch.float32, device=device)
    grid, occ, occ_origin, snap_centers, snap_ids = lift_grid(centers, vs, origin, shape,
                                                              device)
    num_ids = len(centers) + 1
    print(f"[INFO] occupancy {tuple(occ.shape)}, {len(centers)} voxels @ {vs} "
          f"(method={cfg.method})")

    weights_source = read_weights_source(lseg_dir)
    require_untainted(weights_source, allow_random_weights, f"feature dir {lseg_dir}")
    if weights_source is not None:  # carry the taint and lineage to our artifacts
        write_provenance(out_dir, weights_source, stage="lift")
    files = sorted(glob.glob(os.path.join(lseg_dir, "*.npy")))[:cfg.max_views]
    if first_only:
        files = files[:1]
    if not files:
        raise RuntimeError(f"No .npy feature files in {lseg_dir}")
    name_to_entry, cam_params, cam_sizes = load_camera_json(camera_params)
    c2ws, intr, files = camera_arrays_for(files, name_to_entry, cam_params,
                                          cfg.downsample_factor)

    probe = load_feature_map(files[0])
    C = probe.shape[0]
    if image_size is not None:
        H, W = image_size
        H = int(round(H * cfg.downsample_factor))
        W = int(round(W * cfg.downsample_factor))
    elif cam_sizes:
        # the ray grid must match the plane the (downsample-scaled) intrinsics
        # describe: the camera's native image size, not the feature-map size
        # (prepare_tensor_data.py:117-127 upsamples features for that reason)
        wh = next(iter(cam_sizes.values()))
        H = int(round(wh[1] * cfg.downsample_factor))
        W = int(round(wh[0] * cfg.downsample_factor))
    else:
        H, W = probe.shape[1], probe.shape[2]
        print(f"[WARN] camera JSON carries no width/height and no "
              f"image_size given — lifting on the {H}x{W} feature grid; "
              f"intrinsics must describe THIS grid for rays to align")

    inc = float(vs) * cfg.ray_increment_factor
    # one step budget for all views: the smallest focals spread rays widest,
    # and the farthest principal-point deviation sets the longest corner ray
    fx_min = float(np.min(intr[:, 0])) if len(intr) else 1.0
    fy_min = float(np.min(intr[:, 1])) if len(intr) else 1.0
    cx_w = float(np.max(np.maximum(intr[:, 2], W - 1 - intr[:, 2]))) if len(intr) else None
    cy_w = float(np.max(np.maximum(intr[:, 3], H - 1 - intr[:, 3]))) if len(intr) else None
    steps = default_max_steps(W, H, fx_min, fy_min, cfg.depth_min, cfg.depth_max, inc,
                              cx=cx_w, cy=cy_w)
    vs_t, inc_t = torch.tensor(vs, **f32), torch.tensor(inc, **f32)
    occ_origin_t = torch.as_tensor(occ_origin, **f32)

    sums = torch.zeros((num_ids, C), **f32)
    counts = torch.zeros((num_ids,), dtype=torch.int32, device=device)
    overflow_max = torch.zeros((), dtype=torch.int64, device=device)

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    done = 0
    B = cfg.view_chunk
    for start in range(0, len(files), B):
        batch = files[start:start + B]
        for i, fpath in enumerate(batch):
            # the fp16 map goes to the device as stored and is upcast there
            fmap = torch.from_numpy(load_feature_map(fpath)).to(device)
            fmap = resize_features(fmap, H, W).permute(1, 2, 0)        # [H,W,C]
            c2w = torch.as_tensor(c2ws[start + i], **f32)
            K = torch.as_tensor(intr[start + i], **f32)
            if cfg.method == "splat":
                ds, dc, dof = lift_view_splat(
                    snap_centers, snap_ids, c2w, K, vs_t, cfg.depth_min, cfg.depth_max,
                    inc_t, fmap, num_ids, W, H,
                    max_tiles_per_axis=cfg.splat_max_tiles_per_axis,
                    max_per_tile=cfg.splat_max_per_tile,
                    big_budget=cfg.splat_big_budget or None)
                overflow_max = torch.maximum(overflow_max, dof)
            else:
                hits = first_hit_voxels(occ, c2w, K, occ_origin_t, vs_t, cfg.depth_min,
                                        cfg.depth_max, inc_t, W, H, steps)
                ds, dc = scatter_features(fmap, hits, num_ids)
            del fmap
            sums += ds
            counts += dc
        nb = len(batch)
        done += nb
        # fire when done crosses a multiple of checkpoint_every
        if cfg.checkpoint_every and done < len(files) \
                and (done // cfg.checkpoint_every > (done - nb) // cfg.checkpoint_every):
            _write_artifacts(out_dir, done, sums, counts, centers, grid, vs, final=False)
    artifact = _write_artifacts(out_dir, done, sums, counts, centers, grid, vs, final=True)
    dt = time.perf_counter() - t0
    vps = done / dt if dt > 0 else float("inf")
    overflow = int(overflow_max)
    if overflow > 0:
        print(f"[WARN] lift coverage overflow: up to {overflow} "
              f"truncated slots/view (big-voxel budget and/or per-tile "
              f"K cap) — raise LiftConfig.splat_big_budget / "
              f"splat_max_per_tile; pixels past the cap lift the wrong "
              f"voxel silently otherwise")
    print(f"[INFO] lifted {done} views in {dt:.2f}s = {vps:.2f} views/s")
    return {"sums": sums, "counts": counts, "grid": grid, "views_per_sec": vps,
            "overflow": overflow, "artifact": artifact}


def _write_artifacts(out_dir, done, sums, counts, centers, grid, vs, final):
    s = sums.cpu().numpy()[1:]          # drop the miss-collector row 0
    c = counts.cpu().numpy()[1:]
    nz = c > 0
    mean = np.zeros_like(s)
    mean[nz] = s[nz] / c[nz, None]
    coords = grid.coords.cpu().numpy()
    tag = "ALL_nonzero_voxel_features" if final else f"checkpoint_{done}img"
    pt_path = os.path.join(out_dir, f"{tag}_{int(nz.sum())}vox.pt")
    save_voxel_features(pt_path, xyz=centers[nz], avg_feats=mean[nz],
                        voxel_coords=coords[nz][:, ::-1])  # (z,y,x) like the reference
    # hit-count visualization PLY (aggregate…onthefly.py:339-377)
    heat = np.clip(c / max(c.max(), 1), 0, 1)
    cols = np.stack([255 * heat, 64 + 0 * heat, 255 * (1 - heat)], axis=1).astype(np.uint8)
    write_voxel_grid_ply(os.path.join(out_dir, f"{tag}_hitcounts.ply"), centers, cols,
                         float(vs), grid.origin.cpu().numpy(), grid_shape=None)
    return pt_path
