#!/usr/bin/env python
"""Stage-level timing of the rasterizer at the bench's configuration (1080p,
200 000 Gaussians, 32 channels) on the card: the twin of the repo's
scripts/perf_raster_stages.py.

    python -m segsplat_tpu_torch.perf_raster_stages [--n 200000] [--frames 16]
        [--m 3] [--k 256] [--device cuda]

It splits the frame that ``segsplat_tpu_torch.bench`` times end to end into
project → depth argsort → pair-key sort → the two gathers → the blend kernel
K1, one line each, and closes with the stages' sum against the full frame.
The sorts and gathers are timed on seeded data of the binning's shapes and
types (``ops/rasterize.bin_gaussian_ranks`` sorts int64 keys, where the JAX
package sorts uint32 ones); the blend alone runs K1 through
``ops/blend.blend_tiles`` on each frame's own binning and payload.

Each line is ``timeit``'s: CUDA events around F frames, the least of three
sets after one untimed set (no tunnel, so nothing is subtracted). The default
device is the card, and ``--device cuda`` raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from segsplat_tpu_torch.core.types import Camera
from segsplat_tpu_torch.ops import rasterize as R
from segsplat_tpu_torch.ops.blend import blend_tiles, payload_width
from segsplat_tpu_torch.utils.system import require_device

W, H = 1920, 1080
STAGE_CH = 32
SCENE_NAMES = ("xyz", "scales", "quats", "opac", "logits")     # make_scene's arrays


def make_scene(n: int, seed: int = 0):
    """scripts/perf_raster_stages.py:34-44 in numpy: bench.py's headline
    Gaussians (the same draws in the same order). Returns (xyz, scales, quats,
    opac, logits)."""
    rng = np.random.default_rng(seed)
    xyz = (rng.random((n, 3)) * np.array([4.0, 3.0, 4.0])
           + np.array([-2.0, -1.5, 2.0])).astype(np.float32)
    scales = np.exp(rng.normal(-4.6, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, (n,)).astype(np.float32)
    logits = rng.standard_normal((n, STAGE_CH)).astype(np.float32)
    return xyz, scales, quats, opac, logits


def bench_intrinsics(width: int, height: int):
    """(fx, fy, cx, cy) of bench.py's camera (fov 1.2 × 0.75) as the float32
    values its intrinsics hold, as Python floats."""
    cam = Camera(R=torch.eye(3), T=torch.zeros(3), fov_x=torch.tensor(1.2),
                 fov_y=torch.tensor(0.75), width=width, height=height)
    K = cam.intrinsics()
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def vm_of(a: float, width: int, height: int, device="cpu") -> torch.Tensor:
    """[4, 4] world→view matrix of bench.py's camera turned by yaw ``a``."""
    Rm = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]], np.float32)
    cam = Camera(R=torch.as_tensor(Rm), T=torch.zeros(3), fov_x=torch.tensor(1.2),
                 fov_y=torch.tensor(0.75), width=width, height=height)
    return cam.world_view_transform().to(device)


def timeit(name, fn, sets, device, combine=torch.add, unit: str = "ms/frame"):
    """The least time an item takes, in ms, of ``fn`` over ``sets`` (lists of
    its inputs). One untimed pass over the first set comes first: it builds
    the kernels and warms the allocator. Then each set runs ``fn(x)`` for each
    of its items, folding the results on the device with ``combine``, between
    two CUDA events; the host waits for the end event once a set, never once
    an item. On the CPU, where no device exists, the host clock stands in.
    Prints ``name`` and the time when ``name`` is given.

    Returns (ms an item, the folded result of each set)."""
    dev = torch.device(device)

    def run(xs):
        out = None
        for x in xs:
            r = fn(x)
            out = r if out is None else combine(out, r)
        return out

    run(sets[0])
    times, outs = [], []
    for xs in sets:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = run(xs)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = run(xs)
            ms = (time.perf_counter() - t0) * 1e3
        times.append(ms / len(xs))
        outs.append(out)
    best = min(times)
    if name:
        print(f"{name:34s} {best:8.2f} {unit}", flush=True)
    return best, outs


def blend_alone_inputs(t: dict, vms, cam, width: int, height: int, m: int, K: int):
    """Each frame's own blend inputs (offsets and payload rows in per-tile
    runs), as ``rasterize`` hands them to the blend: a list of
    ``ops/rasterize.BlendInputs``."""
    out = []
    for vm in vms:
        proj = R.project_gaussians(t["xyz"], t["scales"], t["quats"], vm, *cam, width, height)
        out.append(R.build_blend_inputs(proj, t["logits"], t["opac"], width, height, m, K))
    return out


def _sum(*xs) -> torch.Tensor:
    return sum(x.float().sum() for x in xs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    n, m, K, F = args.n, args.m, args.k, args.frames
    t = {k: torch.as_tensor(v, device=dev) for k, v in zip(SCENE_NAMES, make_scene(n))}
    cam = bench_intrinsics(W, H)
    bg = torch.zeros(STAGE_CH, device=dev)
    vms = [vm_of(0.002 * i, W, H, dev) for i in range(F)]
    sets = lambda xs: [xs] * 3
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={card}  n={n} m={m} K={K}", flush=True)

    def full(vm):
        out = R.rasterize(t["xyz"], t["scales"], t["quats"], t["opac"], t["logits"], vm, *cam,
                          W, H, bg=bg, max_tiles_per_axis=m, max_per_tile=K, backend="cuda")
        return out["image"][::64, ::64, 0].sum()
    t_full, _ = timeit("full rasterize (K1)", full, sets(vms), dev)

    def project(vm):
        return R.project_gaussians(t["xyz"], t["scales"], t["quats"], vm, *cam, W, H)

    def proj_fn(vm):
        p = project(vm)
        return _sum(p.depths, p.means2d[:, 0], p.radii)
    t_proj, _ = timeit("project", proj_fn, sets(vms), dev)

    def bin_fn(vm):
        order, rank_sorted, offsets, _ = R.bin_gaussian_ranks(project(vm), W, H, m)
        return _sum(offsets, rank_sorted[::4096], order[::4096])
    t_bin, _ = timeit("project + bin", bin_fn, sets(vms), dev)

    # the two sorts alone, on seeded keys of the binning's shapes and types
    rng = np.random.default_rng(1)
    dks = [torch.as_tensor(rng.permutation(np.linspace(0.3, 8.0, n)).astype(np.float32),
                           device=dev) for _ in range(F)]
    t_argsort, _ = timeit("depth argsort [N]",
                          lambda dk: _sum(torch.sort(dk, stable=True).indices[::4096]),
                          sets(dks), dev)
    L = n * m * m
    keys = torch.as_tensor(rng.integers(0, 2 ** 31, size=(F, L), dtype=np.int64), device=dev)
    t_pairsort, _ = timeit(f"pair-key sort [{L}] i64",
                           lambda k: _sum(torch.sort(k).values[::4096]), sets(list(keys)), dev)

    # the gathers of build_blend_inputs: the pairs' Gaussian ids order[ranks],
    # then their payload rows
    pw = payload_width(STAGE_CH)
    orders = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(F)]), device=dev)
    payload = torch.as_tensor(rng.standard_normal((n, pw)).astype(np.float32), device=dev)
    ranks = torch.as_tensor(rng.integers(0, n, size=(F, L)), device=dev)
    t_g1, _ = timeit(f"gather#1 order[ranks] [{L}]", lambda x: _sum(x[0][x[1]][::4096]),
                     sets(list(zip(orders, ranks))), dev)
    t_g2, _ = timeit(f"gather#2 payload[ids] [{L},{pw}]",
                     lambda r: payload[r][::4096, 0].sum(), sets(list(ranks)), dev)
    del dks, keys, orders, ranks, payload

    # the blend alone: K1 on each frame's own binning and payload
    inputs = blend_alone_inputs(t, vms, cam, W, H, m, K)

    def blend_fn(bi):
        img, _ = blend_tiles(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
        return img[::64, ::64, 0].sum()
    t_blend, _ = timeit("blend kernel K1 (blend_tiles)", blend_fn, sets(inputs), dev)

    print("-" * 50)
    acct = t_proj + (t_bin - t_proj) + t_g1 + t_g2 + t_blend
    print(f"accounted {acct:.2f} ms vs full {t_full:.2f} ms "
          f"(bin alone {t_bin - t_proj:.2f}; sorts: depth {t_argsort:.2f} + "
          f"pairs {t_pairsort:.2f})", flush=True)
    return dict(full=t_full, project=t_proj, project_bin=t_bin, depth_argsort=t_argsort,
                pair_sort=t_pairsort, gather1=t_g1, gather2=t_g2, blend=t_blend,
                accounted=acct)


if __name__ == "__main__":
    main()
