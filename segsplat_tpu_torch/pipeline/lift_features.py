"""Multi-view 2D→3D feature aggregation, stage 2 of run_pipeline.py (the
counterpart of segsplat_tpu/pipeline/lift_features.py, after the reference's
cuda_project_image_to_sparse_voxel/aggregate_voxel_features_onthefly.py).

  * the occupancy is built once (ops/voxelize.occupancy_from_grid: the round()
    snap and 1-based ids of build_sparse_occupancy.py),
  * view by view (``ViewLifter``), the map-free part of the lift is queued
    first (the splat's projection, binning and tile test, ops/lift_splat, or
    the DDA's march, ops/lift, for ``method="splat"`` or ``"dda"``); then the
    fp16 feature map goes to the device (on the card through pinned memory
    on a copy stream of its own, ``MapStage``, while the device runs that
    part), is upcast and resized there (bilinear with half-pixel centres,
    antialiased when it shrinks, as ``jax.image.resize``; the reference's
    cv2.INTER_LINEAR per channel), lifted to its first-hit voxels and summed
    into [V+1, C] accumulators in device memory, with the same bits on every
    run,
  * checkpoints whenever the views done cross a multiple of
    ``checkpoint_every``, and the final ``ALL_nonzero_voxel_features`` artifact,
    keep the reference's file contract ({xyz, avg_feats fp16, voxel_coords},
    aggregate…onthefly.py:379-453).

Camera conventions follow prepare_tensor_data.py:165-174: extrinsics arrive as
world→cam (R, tvec) and are inverted to cam→world [Rᵀ | -Rᵀt]; intrinsics
[fx, fy, cx, cy] are scaled by the downsample factor.

With a ``mesh`` of more than one rank (parallel/mesh.py, one process a
device), each view chunk splits over the view ranks, each rank lifts its
share, and the chunk's partial sums, counts and overflow are reduced over
the view ranks (sum, sum, max) before they join the totals, so a checkpoint
holds the global sums; only world rank 0 writes. A mesh with a tensor axis
> 1 raises (``parallel/lift.lift_views_sharded`` splits channels).

Left out of the port: the JAX package's ``_device_put_bounded``, which works
around a transfer limit of the TPU host. No chunk is padded, where the JAX
package pads the tail chunk (and, over a mesh, each chunk to a multiple of
the view axis) with views of zero c2w and intrinsics (1, 1, -1e9, 0). Its
splat lift finds no voxel in such a view, so the results are the same; its
DDA turns their rays into NaN directions that round to voxel (0, 0, 0), which
gains H·W hits of zero features per padded view where it is occupied. The
port lifts only real views, and a rank may get fewer views of a chunk than
another, or none.
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
import torch.distributed as dist
import torch.nn.functional as F

from segsplat_tpu_torch.core.types import VoxelGrid
from segsplat_tpu_torch.io.artifacts import load_feature_map, save_voxel_features
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply, write_voxel_grid_ply
from segsplat_tpu_torch.io.provenance import (read_weights_source, require_untainted,
                                              write_provenance)
from segsplat_tpu_torch.ops.lift import default_max_steps, first_hit_voxels, scatter_features
from segsplat_tpu_torch.ops.lift_splat import splat_accumulate, splat_geometry
from segsplat_tpu_torch.ops.voxelize import occupancy_from_grid
from segsplat_tpu_torch.parallel.mesh import VIEW_AXIS, Mesh, shard_range
from segsplat_tpu_torch.utils.profiling import annotate, count
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
    splat_max_per_tile: int = 256      # a 0.04 m room seen across 2-3 m puts up
    #                                    to 190 cubes behind one 16×16 tile
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


@annotate("lift.resize")
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


class MapStage:
    """A host map's way to the card: the host copies the caller's (pageable)
    array into pinned memory, and the copy from there into one device buffer
    is queued on a copy stream of its own, so the transfer runs while the
    device runs the work queued before on the compute stream. The device
    buffer is made on first use, sized from the map, and made again when a
    map's shape or dtype differs from the last one's (the old one is freed on
    the compute stream, which has waited for its transfers).

    The pinned memory is PyTorch's caching host allocator's (``pin_memory``):
    the transfer records an event on the copy stream, and the allocator hands
    the block out again only once that event is done. Events order the rest,
    with no ``record_stream``: the copy stream waits for ``map_read``, which
    ``read()`` records on the compute stream once the map has been read,
    before it overwrites the device buffer; the compute stream waits for the
    copy stream before anything it queues after ``upload`` reads the buffer.
    On the H100's host a 199 MB map goes whole: copied in slabs, each queued
    as it is done, the host's copy ran slower by more than the transfer the
    slabs would hide (PERF.md §6)."""

    def __init__(self, device: torch.device):
        self.device, self.dev = device, None
        self.stream = torch.cuda.Stream(device)
        self.map_read = torch.cuda.Event()

    def upload(self, fmap_host: np.ndarray) -> torch.Tensor:
        """The map in the device buffer, for work queued next on the compute
        stream. Returns once the host has read ``fmap_host``."""
        src = torch.from_numpy(fmap_host)
        compute = torch.cuda.current_stream(self.device)
        if self.dev is None or self.dev.shape != src.shape or self.dev.dtype != src.dtype:
            self.dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            # the compute stream's allocator may hand out a block that work
            # still queued there uses: the copy stream writes it after that
            self.stream.wait_stream(compute)
        host = src.pin_memory()
        self.stream.wait_event(self.map_read)
        with torch.cuda.stream(self.stream):
            self.dev.copy_(host, non_blocking=True)
        compute.wait_stream(self.stream)
        return self.dev

    def read(self) -> None:
        """Mark the device buffer read by the work queued so far on the
        compute stream."""
        self.map_read.record(torch.cuda.current_stream(self.device))


class ViewLifter:
    """Stage 3 one view at a time, the lift of ``aggregate_voxel_features``:
    set up once from a grid PLY's (centres, voxel_size, grid_origin,
    grid_shape), the ray grid (``height`` × ``width``, the downsampled
    camera's) and ``cfg``, on ``device``; ``lift`` adds one view's host
    feature map into [V+1, C] float32 sums, int32 counts and the most slots a
    view truncated, all in device memory; ``result`` reads them out.

    A view runs in the span ``lift.view``, in this order: the camera's
    tensors (on the card through pinned memory, so their copies wait for
    nothing); the part that reads no map, queued first (the splat's
    ``ops/lift_splat.splat_geometry``, which counts the view's truncated
    slots as ``overflow`` of ``lift.binning``, or the DDA's
    ``first_hit_voxels``, its march bounded by the view's own longest ray);
    the map's upload (``lift.upload``); then ``resize_features``, the permute
    to HWC, the accumulation (``splat_accumulate`` or ``scatter_features``)
    and the adds. On the card a host ``numpy`` map goes through a
    ``MapStage`` (count ``staged`` of ``lift.upload``), so the host's copy
    into pinned memory and the transfer run while the device runs the
    geometry; the stage's device buffer is marked read after the resize.
    Elsewhere (the CPU, or a map already on the device) the map is taken as
    it is. Each view's map crosses to the card whole, every view, and
    ``lift`` returns once the host has read it, so the caller may overwrite
    it then."""

    def __init__(self, centers: np.ndarray, voxel_size: float, origin: np.ndarray, shape,
                 channels: int, height: int, width: int, cfg: LiftConfig = LiftConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg, self.channels, self.height, self.width = cfg, channels, height, width
        self.device = device = torch.device(device)
        self.f32 = dict(dtype=torch.float32, device=device)
        (self.grid, self.occ, occ_origin, self.snap_centers,
         self.snap_ids) = lift_grid(centers, voxel_size, origin, shape, device)
        self.num_ids = len(centers) + 1
        self.inc = float(voxel_size) * cfg.ray_increment_factor
        self.vs_t = torch.tensor(voxel_size, **self.f32)
        self.inc_t = torch.tensor(self.inc, **self.f32)
        self.occ_origin_t = torch.as_tensor(occ_origin, **self.f32)
        self.stage = MapStage(device) if device.type == "cuda" else None
        self.sums, self.counts, self.overflow = self.zeros()

    def zeros(self):
        """A fresh (sums, counts, overflow) triple, as ``lift`` adds into."""
        return (torch.zeros((self.num_ids, self.channels), **self.f32),
                torch.zeros((self.num_ids,), dtype=torch.int32, device=self.device),
                torch.zeros((), dtype=torch.int64, device=self.device))

    def _camera(self, x) -> torch.Tensor:
        """A camera array as float32 on the device; from the host to the card
        through pinned memory, a copy that waits for no queued work."""
        t = torch.as_tensor(x, dtype=torch.float32)
        if t.device.type == "cpu" and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def lift(self, fmap_host: np.ndarray, c2w, intrinsics, into=None) -> None:
        """One view's [C, h, w] host feature map (fp16 as stored), camera to
        world [4, 4] and (fx, fy, cx, cy) of the ray grid, added into ``into``
        (a ``zeros()`` triple; by default the lifter's own)."""
        sums, counts, overflow = self.sums, self.counts, self.overflow
        if into is not None:
            sums, counts, overflow = into
        cfg, W, H = self.cfg, self.width, self.height
        staged = self.stage is not None and isinstance(fmap_host, np.ndarray)
        with annotate("lift.view"):
            c2w_t, K = self._camera(c2w), self._camera(intrinsics)
            if cfg.method == "splat":
                geo = splat_geometry(
                    self.snap_centers, self.snap_ids, c2w_t, K, self.vs_t, cfg.depth_min,
                    cfg.depth_max, self.inc_t, W, H,
                    max_tiles_per_axis=cfg.splat_max_tiles_per_axis,
                    max_per_tile=cfg.splat_max_per_tile,
                    big_budget=cfg.splat_big_budget or None)
            else:
                k = np.asarray(intrinsics, np.float64)
                steps = default_max_steps(W, H, k[0], k[1], cfg.depth_min, cfg.depth_max,
                                          self.inc, cx=k[2], cy=k[3])
                hits = first_hit_voxels(self.occ, c2w_t, K, self.occ_origin_t, self.vs_t,
                                        cfg.depth_min, cfg.depth_max, self.inc_t, W, H, steps)
            with annotate("lift.upload"):
                if staged:
                    fmap = self.stage.upload(fmap_host)
                    count("staged", 1)
                else:
                    fmap = torch.as_tensor(fmap_host, device=self.device)
            fmap = resize_features(fmap, H, W)
            if staged:
                self.stage.read()
            fmap = fmap.permute(1, 2, 0)                                  # [H,W,C]
            if cfg.method == "splat":
                ds, dc, dof = splat_accumulate(geo, fmap, self.num_ids)
                torch.maximum(overflow, dof, out=overflow)
            else:
                ds, dc = scatter_features(fmap, hits, self.num_ids)
            sums += ds
            counts += dc

    def result(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(sums [V+1, C], counts [V+1], the most slots any view truncated);
        row 0 holds no hit. Reading the overflow waits for the device."""
        return self.sums, self.counts, int(self.overflow)


def aggregate_voxel_features(voxel_ply: str, lseg_dir: str, camera_params: str,
                             out_dir: str, cfg: LiftConfig = LiftConfig(),
                             image_size: Optional[Tuple[int, int]] = None,
                             mesh: Optional[Mesh] = None,
                             first_only: bool = False,
                             allow_random_weights: bool = False,
                             device: str | torch.device = "cuda") -> dict:
    """Run the multi-view lift on ``device`` (the card unless the caller asks
    for the CPU, or this rank's device over ``mesh``) through a
    ``ViewLifter``; writes checkpoints and the final artifacts into
    ``out_dir``. Returns {"sums", "counts" (tensors on the device), "grid",
    "views_per_sec", "overflow" (the most slots any view truncated),
    "artifact" (final .pt path; None on ranks but 0)}."""
    device = require_device(device)
    if mesh is not None and mesh.n_tensor > 1:
        raise ValueError(f"the pipeline lift splits views only, not a tensor axis of "
                         f"{mesh.n_tensor}; parallel.lift.lift_views_sharded splits "
                         f"channels")
    sharded = mesh is not None and mesh.size > 1
    writer = mesh is None or mesh.is_rank0
    centers, _, vs, origin, shape = read_voxel_grid_ply(voxel_ply)
    if vs is None:
        raise RuntimeError(f"{voxel_ply}: missing voxel_size header comment")

    weights_source = read_weights_source(lseg_dir)
    require_untainted(weights_source, allow_random_weights, f"feature dir {lseg_dir}")
    if weights_source is not None and writer:  # carry the taint and lineage
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

    lifter = ViewLifter(centers, vs, origin, shape, C, H, W, cfg, device)
    print(f"[INFO] occupancy {tuple(lifter.occ.shape)}, {len(centers)} voxels @ {vs} "
          f"(method={cfg.method})")

    if writer:
        os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    done = 0
    B = cfg.view_chunk
    for start in range(0, len(files), B):
        nb = len(files[start:start + B])
        if sharded:
            # this rank's share of the chunk, then the chunk's totals over the
            # view ranks (the JAX package's psum, psum, pmax)
            part = lifter.zeros()
            lo, hi = shard_range(nb, mesh.n_view, mesh.view_index)
            for i in range(start + lo, start + hi):
                lifter.lift(load_feature_map(files[i]), c2ws[i], intr[i], into=part)
            for x, op in zip(part, (dist.ReduceOp.SUM, dist.ReduceOp.SUM,
                                    dist.ReduceOp.MAX)):
                mesh.all_reduce(x, VIEW_AXIS, op=op)
            lifter.sums += part[0]
            lifter.counts += part[1]
            torch.maximum(lifter.overflow, part[2], out=lifter.overflow)
        else:
            for i in range(start, start + nb):
                lifter.lift(load_feature_map(files[i]), c2ws[i], intr[i])
        done += nb
        # fire when done crosses a multiple of checkpoint_every
        if writer and cfg.checkpoint_every and done < len(files) \
                and (done // cfg.checkpoint_every > (done - nb) // cfg.checkpoint_every):
            _write_artifacts(out_dir, done, lifter.sums, lifter.counts, centers, lifter.grid,
                             vs, final=False)
    sums, counts, overflow = lifter.result()
    artifact = (_write_artifacts(out_dir, done, sums, counts, centers, lifter.grid, vs,
                                 final=True)
                if writer else None)
    dt = time.perf_counter() - t0
    vps = done / dt if dt > 0 else float("inf")
    if overflow > 0:
        print(f"[WARN] lift coverage overflow: up to {overflow} "
              f"truncated slots/view (big-voxel budget and/or per-tile "
              f"K cap) — raise LiftConfig.splat_big_budget / "
              f"splat_max_per_tile; pixels past the cap lift the wrong "
              f"voxel silently otherwise")
    print(f"[INFO] lifted {done} views in {dt:.2f}s = {vps:.2f} views/s")
    return {"sums": sums, "counts": counts, "grid": lifter.grid, "views_per_sec": vps,
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
