#!/usr/bin/env python
"""The port's binning (``ops/rasterize.bin_gaussian_ranks``) dissected stage
by stage on the card: the twin of the repo's scripts/perf_bin_dissect.py.

    python -m segsplat_tpu_torch.perf_bin_dissect [--n 200000] [--frames 8]
        [--m 3] [--device cuda]

Progressive truncation: stage S runs the binning up to its S-th step and
checksums what exists so far, so each line's delta is one step's cost. The
steps are the port's own, line by line: the stable depth sort, the sorted
fields, the pairs in the [m², N] layout, the int64 keys ``tile << rank_bits |
rank`` with rank_bits = ⌈log₂ N⌉, their sort, the rank unpack and the
per-tile search. (The JAX script inlines the JAX package's former [N, m, m]
uint32 layout with rank_bits = 18.) Times come from
``perf_raster_stages.timeit``: CUDA events, the least of three sets after an
untimed one. The default device is the card, and ``--device cuda`` raises
without one.
"""

from __future__ import annotations

import argparse
import math

import torch

from segsplat_tpu_torch.ops import rasterize as R
from segsplat_tpu_torch.perf_raster_stages import (W, H, bench_intrinsics, make_scene, timeit,
                                                   vm_of)
from segsplat_tpu_torch.utils.system import require_device

STAGES = ("project", "+argsort", "+field gathers", "+pair build", "+key pack", "+sort",
          "+rank unpack", "+searchsorted")


def upto(stage: int, proj: R.Projected, width: int, height: int, m: int) -> dict:
    """``bin_gaussian_ranks`` of the projection ``proj`` (opacity cull off,
    tile_row0 0), run up to ``stage`` (0..7, ``STAGES``; 0 is the projection
    alone). Returns what exists so far: ``proj`` (stage 0), ``order`` (1),
    ``means2d``, ``radii``, ``valid`` (2), ``tile_id`` [m², N] and ``rank``
    [N] (3), ``key`` (4), ``skey`` (5), ``rank_sorted`` (6), ``offsets``
    (7)."""
    out = dict(proj=proj)
    if stage == 0:
        return out
    dev = proj.means2d.device
    tx_n, ty_n = -(-width // R.TILE), -(-height // R.TILE)
    num_tiles, n = tx_n * ty_n, proj.means2d.shape[0]
    depth_key = torch.where(proj.valid, proj.depths, math.inf)
    out["order"] = order = torch.sort(depth_key, stable=True).indices
    if stage == 1:
        return out
    out["means2d"] = means2d = proj.means2d[order]
    out["radii"] = radii = proj.radii[order]
    out["valid"] = valid = proj.valid[order]
    if stage == 2:
        return out
    x0 = torch.clamp(torch.floor((means2d[:, 0] - radii) / R.TILE), 0, tx_n - 1).long()
    y0 = torch.clamp(torch.floor((means2d[:, 1] - radii) / R.TILE), 0, ty_n - 1).long()
    x1 = torch.clamp(torch.floor((means2d[:, 0] + radii) / R.TILE), 0, tx_n - 1).long()
    y1 = torch.clamp(torch.floor((means2d[:, 1] + radii) / R.TILE), 0, ty_n - 1).long()
    di = torch.arange(m, device=dev)
    txs = x0[None, :] + di.repeat(m)[:, None]
    tys = y0[None, :] + di.repeat_interleave(m)[:, None]
    in_rect = (txs <= x1[None, :]) & (tys >= 0) & (tys <= y1[None, :]) & valid[None, :]
    out["tile_id"] = tile_id = torch.where(in_rect, tys * tx_n + txs, num_tiles)
    out["rank"] = rank = torch.arange(n, device=dev)
    if stage == 3:
        return out
    rank_bits = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    out["key"] = key = ((tile_id << rank_bits) | rank[None, :]).reshape(-1)
    if stage == 4:
        return out
    out["skey"] = skey = torch.sort(key).values
    if stage == 5:
        return out
    out["rank_sorted"] = skey & ((1 << rank_bits) - 1)
    if stage == 6:
        return out
    probes = torch.arange(num_tiles + 1, device=dev) << rank_bits
    out["offsets"] = torch.searchsorted(skey, probes).to(torch.int32)
    return out


def checksum(out: dict) -> torch.Tensor:
    """A 0-dim sum that reads every tensor ``upto`` returned (every 4096th
    entry of the long ones), so that none of its work is skipped."""
    parts = [out["proj"].radii.sum()]
    for k, v in out.items():
        if k != "proj":
            parts.append(v.reshape(-1)[::4096].float().sum())
    return sum(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    n, m, F = args.n, args.m, args.frames
    xyz, scales, quats = (torch.as_tensor(a, device=dev) for a in make_scene(n)[:3])
    cam = bench_intrinsics(W, H)
    vms = [vm_of(0.002 * i, W, H, dev) for i in range(F)]
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={card}  n={n} m={m}", flush=True)
    project = lambda vm: R.project_gaussians(xyz, scales, quats, vm, *cam, W, H)
    times, prev = [], 0.0
    for s, name in enumerate(STAGES):
        t, _ = timeit(f"stage {s}: {name}", lambda vm: checksum(upto(s, project(vm), W, H, m)),
                      [vms] * 3, dev)
        print(f"    delta {t - prev:+.2f} ms", flush=True)
        times.append(t)
        prev = t
    pairs = int(upto(7, project(vms[0]), W, H, m)["offsets"][-1])
    print(f"real pairs frame0: {pairs} of {n * m * m}", flush=True)
    return dict(stages=dict(zip(STAGES, times)), pairs=pairs)


if __name__ == "__main__":
    main()
