#!/usr/bin/env python
"""Stage-level timing of the feature lift at the bench's configuration
(876×584 rays, 109 000 voxels, 512 channels, splat m = 8, K = 128) on the
card: the twin of the repo's scripts/perf_lift_stages.py.

    python -m segsplat_tpu_torch.perf_lift_stages [--device cuda]

It splits the per-view time behind ``segsplat_tpu_torch.bench``'s
``lift_views_per_s``, on the same scene (``bench.officescene_lift_scene``):
the ×2 bilinear upsample of a 512-channel map, the transpose to HWC (a view
in torch, made contiguous here as the lift's pad copies it), the transposed
order (a channels-last map resized), the splat first hit alone, the
scatter's per-voxel segment sum alone (on seeded hits and features) and the
whole view as the bench runs it. Times come from
``perf_raster_stages.timeit``: CUDA events, the least of three passes over
the 8 views after an untimed one. The default device is the card, and
``--device cuda`` raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from segsplat_tpu_torch import bench
from segsplat_tpu_torch.ops.lift import scatter_features
from segsplat_tpu_torch.ops.lift_splat import first_hit_voxels_splat
from segsplat_tpu_torch.perf_raster_stages import timeit
from segsplat_tpu_torch.pipeline.lift_features import resize_features
from segsplat_tpu_torch.utils.system import require_device

VIEWS = 8


def resize_chw(st: dict, v: int) -> torch.Tensor:
    """View ``v``'s map upsampled to [C, H, W] float32."""
    return resize_features(st["feats"][v], st["H"], st["W"])


def resize_hwc(st: dict, v: int) -> torch.Tensor:
    """The same upsample, then the transpose to a contiguous [H, W, C]."""
    return resize_chw(st, v).permute(1, 2, 0).contiguous()


def transpose_then_resize(st: dict, v: int) -> torch.Tensor:
    """The half-resolution map in the transposed (channels-last) order,
    resized in that order: [H, W, C] in memory."""
    half = st["feats"][v].to(torch.float32)[None].contiguous(memory_format=torch.channels_last)
    up = F.interpolate(half, size=(st["H"], st["W"]), mode="bilinear", align_corners=False,
                       antialias=True)
    return up[0].permute(1, 2, 0)


def first_hit(st: dict, v: int) -> torch.Tensor:
    """The splat first hit of view ``v``: [H, W] voxel ids, 0 = miss."""
    return first_hit_voxels_splat(st["centers"], st["ids"], st["c2ws"][v], st["intr"][v],
                                  st["vs"], 0.01, 10.0, st["inc"], st["W"], st["H"],
                                  max_tiles_per_axis=8, max_per_tile=128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    sc = bench.officescene_lift_scene(n_views=VIEWS)
    st = bench.lift_tensors(sc, dev)
    W, H, C, nv = sc["W"], sc["H"], sc["C"], len(sc["centers"])
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={card}  {W}x{H} {C}ch {nv} vox", flush=True)
    views = [list(range(VIEWS))] * 3
    line = lambda name, fn: timeit(f"{name:40s}", fn, views, dev, unit="ms/view")[0]
    out = {
        "resize": line("resize CHW f32", lambda v: resize_chw(st, v)[:, ::64, ::64].sum()),
        "resize_transpose": line("resize + transpose -> HWC",
                                 lambda v: resize_hwc(st, v)[::64, ::64, 0].sum()),
        "transpose_resize": line("transpose(half) + resize HWC",
                                 lambda v: transpose_then_resize(st, v)[::64, ::64, 0].sum()),
        "first_hit": line("splat first-hit [H,W]",
                          lambda v: first_hit(st, v)[::64, ::64].float().sum()),
    }
    # the scatter alone, on seeded hits and features of the view's shapes
    rng = np.random.default_rng(2)
    hitmaps = torch.as_tensor(rng.integers(0, nv + 1, size=(VIEWS, H, W)).astype(np.int32),
                              device=dev)
    fmap_full = torch.as_tensor(rng.random((H, W, C)).astype(np.float32), device=dev)

    def scatter(v):
        ds, dc = scatter_features(fmap_full, hitmaps[v], nv + 1)
        return ds[::64, ::64].sum() + dc[::64].float().sum()
    out["scatter"] = line(f"scatter segment_sum [{H * W // 1000}k x {C}]", scatter)
    del hitmaps, fmap_full

    def full(v):
        ds, dc, _ = bench.lift_view(st, v)
        return ds[::64, ::64].sum() + dc[::64].float().sum()
    out["full"] = line("FULL view (resize+splat+scatter)", full)
    return out


if __name__ == "__main__":
    main()
