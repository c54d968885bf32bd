#!/usr/bin/env python
"""Benchmark of the port on one NVIDIA GPU: semantic novel-view render FPS at
1080p (200 000 Gaussians, 32 logit channels), with the adversarial render
scene and the officescene-scale feature-lift throughput on the same line. The
twin of the repo's bench.py.

    python -m segsplat_tpu_torch.bench [--device cuda]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"},
with bench.py's keys. ``vs_baseline`` is the frame rate over the 30-FPS bar
(the north star's target, a definition, not a measurement). ``extra`` holds
``lift_views_per_s``, ``lift_config`` and ``hostile_render`` (its FPS, its
largest real pair count in a frame and its largest per-tile K-cap overflow);
bench.py's ``lift_vs_baseline`` and ``lift_baseline_views_per_s`` are left
out, because their denominator (baseline_host_lift.json) was measured on
another host with cv2.

Each frame is bench.py's: ``rasterize`` on kernel K1, then the argmax over the
channels, summed. Times come from CUDA events around sets of distinct view
matrices (16 frames a set, the least of 3 sets after one untimed set that
builds the kernels); the pair counts are folded on the device and read once a
set. The lift runs the per-view work of ``lift_all``: a ×2 bilinear upsample
of the fp16 maps, the transpose to HWC and ``lift_view_splat`` (m = 8,
K = 128), on maps copied to the card once, before the timed sets. Without a
card, ``--device cuda`` prints the error line and exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from segsplat_tpu_torch.ops.lift_splat import lift_view_splat
from segsplat_tpu_torch.ops.rasterize import rasterize
from segsplat_tpu_torch.perf_raster_stages import (SCENE_NAMES, bench_intrinsics, make_scene,
                                                   timeit, vm_of)
from segsplat_tpu_torch.pipeline.lift_features import resize_features

FRAMES, SETS = 16, 3                # headline frames a set, timed sets
HOSTILE_FRAMES = 8
LIFT_VIEWS, LIFT_REPS = 8, 3
LIFT_SIZE = (876, 584, 512, 109_000)    # rays W × H, channels, voxels
BASELINE_FPS = 30.0


def headline_render_scene(W: int = 1920, H: int = 1080, N: int = 200_000) -> dict:
    """bench.py:80-102 in numpy (seed 0; ``perf_raster_stages.make_scene``'s
    arrays): N Gaussians in a 4 m box in front of the camera, 32 channels;
    m = 3, K = 256, pair_cap 1.5 M on K1."""
    xyz, scales, quats, opac, logits = make_scene(N)
    kw = dict(width=W, height=H, max_tiles_per_axis=3, max_per_tile=256,
              backend="cuda", pair_cap=1_500_000)
    return dict(xyz=xyz, scales=scales, quats=quats, opac=opac, logits=logits, kw=kw,
                W=W, H=H)


def hostile_render_scene(W: int = 1920, H: int = 1080, N: int = 200_000) -> dict:
    """bench.py:105-132 in numpy (seed 7): 40 tight clusters of pareto-sized
    counts, log-normal mixed scales (~5–60 px splats), a low-opacity tail;
    m = 6, K = 512, pair_cap 6 M."""
    rng = np.random.default_rng(7)
    n_clusters = 40
    cl_centers = (rng.random((n_clusters, 3)) * np.array([4.0, 3.0, 4.0])
                  + np.array([-2.0, -1.5, 2.0]))
    w = rng.pareto(1.2, n_clusters) + 0.05
    counts = np.maximum((w / w.sum() * N).astype(int), 1)
    counts[0] += N - counts.sum()
    assign = np.repeat(np.arange(n_clusters), counts)[:N]
    xyz = (cl_centers[assign] + rng.normal(0, 0.08, (N, 3))).astype(np.float32)
    scales = np.exp(rng.normal(-4.3, 0.8, (N, 3))).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.02, 0.9, (N,)).astype(np.float32)
    logits = rng.standard_normal((N, 32)).astype(np.float32)
    kw = dict(width=W, height=H, max_tiles_per_axis=6, max_per_tile=512,
              backend="cuda", pair_cap=6_000_000)
    return dict(xyz=xyz, scales=scales, quats=quats, opac=opac, logits=logits, kw=kw,
                W=W, H=H)


def officescene_lift_scene(n_views: int = 8, size=LIFT_SIZE) -> dict:
    """bench.py:294-325 in numpy (seed 1): W × H rays (876×584), ``voxels``
    voxel centres at 0.04 m drawn without repeats from a 60×44×42 box at
    (-1.2, -0.9, 1.0) with ids 1.., fp16 [n_views, C, H/2, W/2] feature maps
    (C = 512) drawn one view at a time (the bits of bench.py's one draw, in
    its order, without its float64 array of every view), fx = fy = 350, views
    turned by 0.02 rad each. ``size`` = (W, H, C, voxels); the defaults are
    bench.py's, smaller ones are for tests. Also returns the box's origin and
    shape, for a grid PLY of the same voxels."""
    W, H, C, nv = size
    rng = np.random.default_rng(1)
    vs = 0.04
    grid_shape = (60, 44, 42)
    coords = rng.choice(int(np.prod(grid_shape)), size=nv, replace=False)
    ii = np.stack(np.unravel_index(coords, grid_shape), axis=1)
    origin = np.array([-1.2, -0.9, 1.0], np.float32)
    centers = (origin + ii * vs).astype(np.float32)
    ids = np.arange(1, nv + 1, dtype=np.int32)
    feats = np.empty((n_views, C, H // 2, W // 2), np.float16)
    for v in range(n_views):
        feats[v] = rng.random((C, H // 2, W // 2))
    fx = 700.0 * 0.5
    intr = np.tile(np.array([fx, fx, W / 2, H / 2], np.float32), (n_views, 1))
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for i in range(n_views):
        a = 0.02 * i
        c2ws[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    return dict(W=W, H=H, C=C, vs=vs, centers=centers, ids=ids, feats=feats, intr=intr,
                c2ws=c2ws, origin=origin, grid_shape=grid_shape)


def scene_tensors(sc: dict, device) -> dict:
    """A render scene's arrays on ``device``."""
    return {k: torch.as_tensor(sc[k], device=device) for k in SCENE_NAMES}


def frame(t: dict, vm, cam, bg, kw: dict) -> torch.Tensor:
    """One frame of bench.py:162-166: ``rasterize`` (kernel K1 on the card, its
    plain version on the CPU), then the argmax over the channels summed over
    the pixels. Returns [probe, num_pairs, tile_overflow] int64 on the device."""
    out = rasterize(t["xyz"], t["scales"], t["quats"], t["opac"], t["logits"], vm, *cam,
                    kw["width"], kw["height"], bg=bg, max_tiles_per_axis=kw["max_tiles_per_axis"],
                    max_per_tile=kw["max_per_tile"], backend=kw["backend"],
                    pair_cap=kw["pair_cap"])
    return torch.stack([out["image"].argmax(-1).sum(), out["num_pairs"].long(),
                        out["tile_overflow"].long()])


def view_sets(sc: dict, step: float, frames: int, sets: int, device) -> list:
    """``sets`` lists of ``frames`` distinct view matrices, yaw ``step`` apart:
    no two frames of a run share a camera."""
    return [[vm_of(step * (r * frames + i), sc["W"], sc["H"], device) for i in range(frames)]
            for r in range(sets)]


def render_sets(sc: dict, step: float, frames: int, sets: int, device, combine=torch.add):
    """A render scene's frames over ``view_sets``, timed by ``timeit``: (ms a
    frame, each set's frames folded by ``combine``)."""
    t = scene_tensors(sc, device)
    bg = torch.zeros(32, device=device)
    cam = bench_intrinsics(sc["W"], sc["H"])
    return timeit(None, lambda vm: frame(t, vm, cam, bg, sc["kw"]),
                  view_sets(sc, step, frames, sets, device), device, combine=combine)


def bench_hostile_render(device, W=1920, H=1080, N=200_000, frames=HOSTILE_FRAMES,
                         sets=SETS) -> dict:
    """The adversarial scene (bench.py:227-291): its FPS, the largest real
    pair count of a frame and the largest per-tile K-cap overflow over the
    timed sets (pair_cap 6 M is exact while num_pairs stays below it), folded
    on the device with a max and read once a set."""
    ms, outs = render_sets(hostile_render_scene(W, H, N), 0.003, frames, sets, device,
                           combine=torch.maximum)
    peak = torch.stack(outs).amax(0).tolist()
    return {"fps": round(1e3 / ms, 2),
            "config": f"{H}p {N // 1000}k clustered/mixed-scale/low-opacity m=6 K=512",
            "max_pairs_per_frame": int(peak[1]),
            "tile_overflow_max": int(peak[2])}


def lift_tensors(sc: dict, device) -> dict:
    """A lift scene on ``device``: its maps, cameras, voxels and the lift's
    constants (bench.py:335-341)."""
    f32 = dict(dtype=torch.float32, device=device)
    return dict(W=sc["W"], H=sc["H"], C=sc["C"], num_ids=len(sc["centers"]) + 1,
                feats=torch.as_tensor(sc["feats"], device=device),
                c2ws=torch.as_tensor(sc["c2ws"], **f32), intr=torch.as_tensor(sc["intr"], **f32),
                centers=torch.as_tensor(sc["centers"], **f32),
                ids=torch.as_tensor(sc["ids"], device=device),
                vs=torch.tensor(sc["vs"], **f32), inc=torch.tensor(sc["vs"] * 0.5, **f32))


def lift_view(st: dict, v: int):
    """View ``v``'s work in bench.py's ``lift_all``: the ×2 bilinear upsample of
    its fp16 map to [C, H, W] float32, the transpose to HWC and the fused
    first-hit splat and accumulation (m = 8, K = 128). Returns (sums
    [num_ids, C], counts [num_ids], overflow)."""
    fmap = resize_features(st["feats"][v], st["H"], st["W"]).permute(1, 2, 0)
    return lift_view_splat(st["centers"], st["ids"], st["c2ws"][v], st["intr"][v], st["vs"],
                           0.01, 10.0, st["inc"], fmap, st["num_ids"], st["W"], st["H"],
                           max_tiles_per_axis=8, max_per_tile=128)


def bench_lift(device, n_views=LIFT_VIEWS, reps=LIFT_REPS, size=LIFT_SIZE) -> float:
    """Feature-lift views/s at officescene scale (bench.py:328-372): the views
    of a pass accumulate into one table, as ``lift_all``'s scan does; the
    least of ``reps`` passes after an untimed one."""
    st = lift_tensors(officescene_lift_scene(n_views, size), device)
    ms, _ = timeit(None, lambda v: lift_view(st, v)[:2], [list(range(n_views))] * reps, device,
                   combine=lambda a, b: (a[0] + b[0], a[1] + b[1]))
    return 1e3 / ms


def _probe_device(device) -> None:
    """bench.py's _probe_backend: the error line and exit 1 when the card is
    missing."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({
            "metric": "semantic_render_fps", "value": 0.0, "unit": "fps",
            "vs_baseline": 0.0,
            "extra": {"error": "CUDA device unreachable: torch.cuda.is_available() is False"}}))
        sys.exit(1)


def main(argv=None, *, device=None, width=1920, height=1080, n=200_000, frames=FRAMES,
         sets=SETS, hostile_frames=HOSTILE_FRAMES, lift_views=LIFT_VIEWS, lift_reps=LIFT_REPS,
         lift_size=LIFT_SIZE) -> dict:
    """Run the three benches and print their line; the keywords are sizes
    (bench.py's by default), and ``device`` comes from ``--device`` unless
    given. Returns the printed object."""
    if device is None:
        ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        ap.add_argument("--device", default="cuda")
        device = ap.parse_args(argv).device
    _probe_device(device)
    device = torch.device(device)
    ms, _ = render_sets(headline_render_scene(width, height, n), 0.002, frames, sets, device)
    fps = 1e3 / ms
    hostile = bench_hostile_render(device, width, height, n, hostile_frames, sets)
    vps = bench_lift(device, lift_views, lift_reps, lift_size)
    W, H, C, nv = lift_size
    line = {
        "metric": "semantic_render_fps_1080p_200k",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "extra": {
            "lift_views_per_s": round(vps, 2),
            "lift_config": f"{W}x{H} rays, {nv // 1000}k vox, {C}ch, splat m=8 K=128",
            "hostile_render": hostile,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
