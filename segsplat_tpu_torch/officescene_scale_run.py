#!/usr/bin/env python
"""The production run at officescene scale on PyTorch/CUDA, the twin of the
repo's scripts/officescene_scale_run.py: fabricate a trained-model stand-in at
the reference's production dimensions (200 000 Gaussians, 876×584 lift and
render, 512-channel LSeg-shaped features, 216 orbit cameras; stage 1 keeps
77 358 voxels at 0.04 m of this seeded room), then drive the pipeline twin ``segsplat_tpu_torch.run_pipeline``
through all five stages with the 13 officescene prompts, stage 5 on the blend
kernel, and report each stage's wall time.

    python -m segsplat_tpu_torch.officescene_scale_run [--work DIR]
        [--lift_views 16] [--render_views 216] [--skip_render] [--smoke]
        [--device cuda|cpu]

Scale anchors: images 1752×1168 lifted at 0.5 (the lift's downsample),
features saved at short side 360 → [512, 360, 540] fp16, 216 views. One
feature map is written and symlinked for every view: each view's bytes and
arithmetic are a real view's, but all reads of the maps hit one file.

``--smoke`` selects the small dimensions (``SMOKE``, 1/10 of the scene, at
most 4 lifted views) and nothing else: ``--smoke --device cpu`` is the JAX
script's ``--smoke``, which also forces its CPU backend. The default device is
the card, and ``--device cuda`` raises without one. Stage 5 runs the blend
kernel on the card (its plain version on the CPU), with no fallback.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from argparse import ArgumentParser
from typing import Optional

import numpy as np
from PIL import Image

from segsplat_tpu_torch import run_pipeline
from segsplat_tpu_torch.core.transforms import rotmat2qvec
from segsplat_tpu_torch.io.colmap import (ColmapCamera, ColmapImage, write_extrinsics_binary,
                                          write_intrinsics_binary, write_points3D_binary)
from segsplat_tpu_torch.io.ply import save_gaussian_ply
from segsplat_tpu_torch.utils.system import require_device

# the 13 officescene prompts (the reference's voxeltoGaussian_logits.sh)
PROMPTS = ["chair", "cabinet", "window", "wall", "door", "keyboard",
           "ceiling", "floor", "table", "laptop", "paper", "light", "monitor"]


@dataclasses.dataclass(frozen=True)
class SceneDims:
    """The fabricated scene's sizes: Gaussians, orbit views, the cameras'
    native image and the render (and 0.5-lift) image, the on-disk feature map
    [channels, feat_h, feat_w], the native focal length, and the most views
    the run lifts (None: as many as asked)."""
    gaussians: int
    views: int
    native_w: int
    native_h: int
    render_w: int
    render_h: int
    feat_h: int
    feat_w: int
    channels: int
    fx_native: float
    max_lift_views: Optional[int] = None


FULL = SceneDims(gaussians=200_000, views=216, native_w=1752, native_h=1168,
                 render_w=876, render_h=584, feat_h=360, feat_w=540, channels=512,
                 fx_native=1400.0)
SMOKE = SceneDims(gaussians=20_000, views=12, native_w=438, native_h=292,
                  render_w=219, render_h=146, feat_h=90, feat_w=135, channels=64,
                  fx_native=350.0, max_lift_views=4)


def room_points(rng, n):
    """Gaussian centres shaped like a furnished room: floor, ceiling and wall
    shells plus 30 clutter blobs, in draws of ``rng`` as the JAX script takes
    them."""
    L, Hh, D = 3.6, 2.8, 3.6                       # room extents (m)
    counts = [int(n * f) for f in (0.14, 0.14, 0.10, 0.10, 0.07, 0.07)]
    u = rng.random
    walls = []
    k = counts[0]; walls.append(np.stack(          # floor / ceiling
        [u(k) * L - L / 2, np.zeros(k), u(k) * D - D / 2], 1))
    k = counts[1]; walls.append(np.stack(
        [u(k) * L - L / 2, np.full(k, Hh), u(k) * D - D / 2], 1))
    k = counts[2]; walls.append(np.stack(          # side walls
        [np.full(k, -L / 2), u(k) * Hh, u(k) * D - D / 2], 1))
    k = counts[3]; walls.append(np.stack(
        [np.full(k, L / 2), u(k) * Hh, u(k) * D - D / 2], 1))
    k = counts[4]; walls.append(np.stack(          # back / front walls
        [u(k) * L - L / 2, u(k) * Hh, np.full(k, -D / 2)], 1))
    k = counts[5]; walls.append(np.stack(
        [u(k) * L - L / 2, u(k) * Hh, np.full(k, D / 2)], 1))
    pts = [np.concatenate(walls) + rng.normal(0, 0.015, (sum(counts), 3))]
    remaining = n - sum(counts)                    # clutter: 30 furniture-like blobs
    blob_c = np.stack([u(30) * (L - 1) - (L - 1) / 2, u(30) * 1.2,
                       u(30) * (D - 1) - (D - 1) / 2], 1)
    per = remaining // 30
    for b in range(30):
        k = per if b < 29 else remaining - per * 29
        pts.append(blob_c[b] + rng.normal(0, 0.22, (k, 3)) * np.array([1.0, 0.6, 1.0]))
    p = np.concatenate(pts)
    # the camera corridor (xz-radius 1.1, y ≈ 1.3) is carved: clutter there
    # would make every ray hit at its origin. Walls stay; clutter inside the
    # cylinder is pushed radially out to the 1.45 m shell.
    r_xz = np.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2)
    inside = (r_xz < 1.45) & (p[:, 1] > 0.3) & (p[:, 1] < 2.4)
    scale = np.where(inside, (1.45 + 0.2 * rng.random(len(p))) / np.maximum(r_xz, 0.2), 1.0)
    p[:, 0] *= scale
    p[:, 2] *= scale
    p[:, 0] = np.clip(p[:, 0], -L / 2, L / 2)
    p[:, 2] = np.clip(p[:, 2], -D / 2, D / 2)
    return p[:n].astype(np.float32)


def fabricate(work: str, rng, dims: SceneDims = FULL):
    """Write the trained-model stand-in under ``work``: the COLMAP scene
    (``scene/``), the model dir with its 30 000-iteration PLY and cfg_args
    (``model/``), the lift's camera JSON and one fp16 feature map symlinked for
    every view (``lseg_features/``). The same draws of ``rng`` in the same
    order as the JAX script, so the same bytes. Returns (scene, model, feature
    dir, camera JSON) paths."""
    src = os.path.join(work, "scene")
    model = os.path.join(work, "model")
    lseg = os.path.join(work, "lseg_features")
    pc_dir = os.path.join(model, "point_cloud", "iteration_30000")
    for d in (os.path.join(src, "sparse", "0"), os.path.join(src, "images"), lseg, pc_dir):
        os.makedirs(d, exist_ok=True)

    # the Gaussians in storage conventions: opacity before the sigmoid, log scales
    xyz = room_points(rng, dims.gaussians)
    n = len(xyz)
    f_dc = rng.random((n, 1, 3)).astype(np.float32) - 0.5
    f_rest = np.zeros((n, 15, 3), np.float32)
    opacity = np.full((n, 1), 2.2, np.float32)          # sigmoid → 0.90
    scaling = rng.normal(-4.0, 0.3, (n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    obj_dc = rng.normal(0, 0.1, (n, 1, 16)).astype(np.float32)
    save_gaussian_ply(os.path.join(pc_dir, "point_cloud.ply"), xyz, f_dc, f_rest, opacity,
                      scaling, rots, obj_dc)
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write("Namespace(sh_degree=3, source_path=%r, model_path=%r, "
                "images='images', object_path='object_mask', resolution=-1, "
                "white_background=False, train_split=False, eval=False)" % (src, model))

    # orbit cameras: the scene's at the render size, the lift's camera JSON at
    # the native size and intrinsics (the lift downsamples by 0.5)
    W, H = dims.render_w, dims.render_h
    cams = {1: ColmapCamera(id=1, model="PINHOLE", width=W, height=H,
                            params=np.array([dims.fx_native / 2, dims.fx_native / 2,
                                             W / 2, H / 2]))}
    images = {}
    cam_json = {"images": {}, "cameras": {
        "1": {"model": "PINHOLE", "width": dims.native_w, "height": dims.native_h,
              "params": [dims.fx_native, dims.native_w / 2, dims.native_h / 2]}}}
    flat = Image.fromarray(np.full((H, W, 3), 128, np.uint8))
    for i in range(dims.views):
        ang = 2 * np.pi * i / dims.views
        pos = np.array([1.1 * np.sin(ang), 1.3 + 0.15 * np.sin(3 * ang), -1.1 * np.cos(ang)])
        # looking inward across the corridor at the far clutter and wall
        fwd = np.array([0.0, 1.15, 0.0]) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        Rwc = np.stack([right, up, fwd], axis=0)
        tvec = -Rwc @ pos
        name = f"frame_{i:03d}.png"
        flat.save(os.path.join(src, "images", name))
        images[i + 1] = ColmapImage(
            id=i + 1, qvec=rotmat2qvec(Rwc), tvec=tvec, camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))
        cam_json["images"][str(i + 1)] = {"name": name, "R": Rwc.tolist(),
                                          "tvec": tvec.tolist(), "camera_id": "1"}
    write_intrinsics_binary(os.path.join(src, "sparse", "0", "cameras.bin"), cams)
    write_extrinsics_binary(os.path.join(src, "sparse", "0", "images.bin"), images)
    sel = rng.choice(n, min(30_000, n), replace=False)
    write_points3D_binary(os.path.join(src, "sparse", "0", "points3D.bin"), xyz[sel],
                          np.full((len(sel), 3), 127, np.uint8))
    cam_params = os.path.join(work, "camera_params.json")
    with open(cam_params, "w") as f:
        json.dump(cam_json, f)

    # one [C, feat_h, feat_w] fp16 map, symlinked for every other view
    feat = rng.standard_normal((dims.channels, dims.feat_h, dims.feat_w)).astype(np.float16)
    feat_path = os.path.join(lseg, "frame_000.npy")
    np.save(feat_path, feat)
    for i in range(1, dims.views):
        link = os.path.join(lseg, f"frame_{i:03d}.npy")
        if not os.path.exists(link):
            os.symlink(feat_path, link)
    return src, model, lseg, cam_params


def run(work: str, dims: SceneDims = FULL, lift_views: int = 16, render_views: int = 216,
        skip_render: bool = False, device: str = "cuda") -> dict:
    """Fabricate the scene at ``dims`` under ``work`` and run the pipeline twin
    on ``device``. Returns run_pipeline.main's dict, its "timing" led by
    "fabricate"."""
    require_device(device)
    if dims.max_lift_views is not None:
        lift_views = min(lift_views, dims.max_lift_views)
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    src, model, lseg, cam_params = fabricate(work, np.random.default_rng(0), dims)
    fabricate_s = time.perf_counter() - t0
    print(f"[FABRICATE] {fabricate_s:.1f}s")

    # the JAX script's arguments, stage 5 on the kernel
    argv = ["-s", src, "-m", model, "--iteration", "30000",
            "--lseg_dir", lseg, "--camera_params", cam_params,
            "--prompt", *PROMPTS, "--cell_size", "0.04",
            "--opacity_threshold", "0.2", "--view_chunk", "4",
            "--max_views", str(lift_views), "--render_views", str(render_views),
            "--work_dir", os.path.join(work, "semantic_pipeline"),
            "--render_backend", "cuda", "--device", device]
    if skip_render:
        argv.append("--skip_render")
    stdout = sys.stdout             # stage 5's safe_state timestamps stdout
    t0 = time.perf_counter()
    try:
        out = run_pipeline.main(argv)
    finally:
        sys.stdout = stdout
    print(f"[TOTAL] {time.perf_counter() - t0:.1f}s (lift_views={lift_views})")
    out["timing"] = {"fabricate": fabricate_s, **out["timing"]}
    return out


def main(argv=None) -> dict:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", default="",
                   help="work dir (default: officescene_scale, or officescene_smoke with "
                        "--smoke, in the temporary directory)")
    p.add_argument("--lift_views", type=int, default=16)
    p.add_argument("--render_views", type=int, default=FULL.views)
    p.add_argument("--skip_render", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="the small dimensions (~1/10 of the scene, at most 4 lifted "
                        "views): a dry run of the same five stages; its numbers are not "
                        "scale numbers")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) raises when no card is present")
    args = p.parse_args(argv)
    dims = SMOKE if args.smoke else FULL
    work = args.work or os.path.join(
        tempfile.gettempdir(), "officescene_smoke" if args.smoke else "officescene_scale")
    return run(work, dims, args.lift_views, args.render_views, args.skip_render, args.device)


if __name__ == "__main__":
    main()
