"""Splat-formulated first-hit ray march, the default feature lift (the
counterpart of segsplat_tpu/ops/lift_splat.py).

First hit as voxel splatting, on the tile rasterizer's structure:
  1. project the occupied voxel cubes to the image (8-corner screen AABB),
  2. bin voxels to 16×16 pixel tiles, nearest first, with the rasterizer's
     sort of (tile, depth rank) keys (ops/rasterize.bin_gaussian_ranks), or the
     two-class binning of ``_bin_voxels_dual``,
  3. per tile, test its pixels' rays against the K nearest candidate cubes
     with an exact slab test in world space, and keep the minimum-entry hit.

The semantics are the reference kernel's sampled march, miss-on-grazing
included: a voxel registers only if a march sample t = depth_min/dz +
k·increment lands inside its cube (project_image_cuda_kernel.cu:31-91), so
the hit is the first on-grid sample after slab entry, and it must precede
slab exit. ``lift_view_splat`` accumulates per tile: a one-hot [K, 256] ×
[256, CH] product (``torch.bmm``, fp32: TF32 is off in this package) gives
each candidate's partial sum, and one per-voxel sum over the T·K slots
(``ops/voxelize.segment_sum``, the same bits on every run) merges them. Every
sort is stable, as ``jnp.argsort``, because ties decide which voxels form the
dual bin's big set.

Each stage runs inside a ``torch.profiler.record_function`` range,
``lift.projection``, ``lift.binning``, ``lift.tile_test`` and
``lift.accumulation``, so a profiler trace gives each stage's device time (the
kernels launched inside the range); without a profiler a range costs a few µs
of host time.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from segsplat_tpu_torch.ops.rasterize import (TILE, Projected, bin_gaussian_ranks,
                                              map_tile_chunks, tiles_to_image)
from segsplat_tpu_torch.ops.voxelize import segment_sum

# Tiles per chunk of the tile test. The JAX package's 64 was sized for TPU
# memory; on the card 64 issues ~5 000 launches a view and leaves the device
# idle most of the time. 2 048 holds a 876×584 view's 2 035 tiles in one chunk
# (chip_smoke.py phase 8 measures 64, 512 and all tiles; PERF.md has the
# numbers) and bounds the [chunk, K, 256] temporaries on larger views.
TILE_CHUNK = 2048


@record_function("lift.projection")
def _project_voxels(centers: torch.Tensor, half, w2c: torch.Tensor,
                    intrinsics: torch.Tensor, width: int, height: int,
                    depth_max: float):
    """Screen AABB of each voxel cube over its 8 corners, in planar [V]
    components. Returns (means2d [V, 2], radius_px, depth, valid)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    R, t = w2c[:3, :3], w2c[:3, 3]
    wxc, wyc, wzc = centers[:, 0], centers[:, 1], centers[:, 2]
    z = R[2, 0] * wxc + R[2, 1] * wyc + R[2, 2] * wzc + t[2]    # [V]

    u0 = v0 = u1 = v1 = any_front = None
    for sx_ in (-1.0, 1.0):
        for sy_ in (-1.0, 1.0):
            for sz_ in (-1.0, 1.0):
                px = wxc + half * sx_
                py = wyc + half * sy_
                pz = wzc + half * sz_
                ccx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
                ccy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
                ccz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
                czs = torch.clamp_min(ccz, 1e-6)
                u = fx * ccx / czs + cx
                v = fy * ccy / czs + cy
                if u0 is None:
                    any_front, u0, u1, v0, v1 = ccz > 0, u, u, v, v
                else:
                    any_front = (ccz > 0) | any_front
                    u0, u1 = torch.minimum(u0, u), torch.maximum(u1, u)
                    v0, v1 = torch.minimum(v0, v), torch.maximum(v1, v)
    means2d = torch.stack([(u0 + u1) * 0.5, (v0 + v1) * 0.5], dim=1)
    radius = torch.maximum(u1 - u0, v1 - v0) * 0.5 + 1.0
    valid = (any_front & (z < depth_max * 1.74)
             & (u1 > 0) & (u0 < width) & (v1 > 0) & (v0 < height))
    return means2d, radius, z, valid


def _bin_voxels(means2d, radius, depth, valid, width: int, height: int,
                max_tiles_per_axis: int):
    """Nearest-first per-tile candidate lists: the rasterizer's binning of
    the voxels' screen AABBs. Returns (order, rank_sorted, offsets, (tx_n, ty_n))."""
    proj = Projected(means2d=means2d, depths=depth,
                     conics=torch.zeros((means2d.shape[0], 3), device=means2d.device),
                     radii=torch.where(valid, radius, 0.0), valid=valid)
    return bin_gaussian_ranks(proj, width, height, max_tiles_per_axis)


def _bin_voxels_dual(means2d, radius, depth, valid, width: int, height: int,
                     max_tiles_per_axis: int, big_budget: int, m_small: int = 2):
    """Two-class binning: every voxel emits m_small² (tile, rank) slots, except
    a ``big_budget``-sized set, chosen by screen span, largest first, that emits
    the full m². Exact whenever at most ``big_budget`` voxels span more than
    m_small tiles; the others are cut to the top-left m_small × m_small tiles of
    their AABB and counted in the returned ``overflow``.

    Falls back to the single-pass ``_bin_voxels`` when m ≤ m_small or when the
    JAX package's 32-bit key would not hold rank and tile (its rule, kept
    although the int64 keys here would have room, since it decides which
    binning runs). Returns (order, rank_sorted, offsets, (tx_n, ty_n), overflow)."""
    dev = means2d.device
    tx_n = -(-width // TILE)
    ty_n = -(-height // TILE)
    num_tiles = tx_n * ty_n
    n = means2d.shape[0]
    m = max_tiles_per_axis
    rank_bits = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    tile_bits = max(int(math.ceil(math.log2(num_tiles + 2))), 1)
    if rank_bits + tile_bits > 32 or m <= m_small:
        o, r, off, dims = _bin_voxels(means2d, radius, depth, valid, width, height, m)
        return o, r, off, dims, torch.zeros((), dtype=torch.int32, device=dev)

    depth_key = torch.where(valid, depth, math.inf)
    order = torch.sort(depth_key, stable=True).indices              # front to back
    m2d = means2d[order]
    rad = torch.where(valid, radius, 0.0)[order]
    val = valid[order]

    # floor → clip → int cast, in that order
    x0 = torch.clamp(torch.floor((m2d[:, 0] - rad) / TILE), 0, tx_n - 1).long()
    y0 = torch.clamp(torch.floor((m2d[:, 1] - rad) / TILE), 0, ty_n - 1).long()
    x1 = torch.clamp(torch.floor((m2d[:, 0] + rad) / TILE), 0, tx_n - 1).long()
    y1 = torch.clamp(torch.floor((m2d[:, 1] + rad) / TILE), 0, ty_n - 1).long()
    span = torch.maximum(x1 - x0, y1 - y0)                           # [N] tiles - 1

    B = min(big_budget, n)
    sel_pos = torch.sort(-torch.where(val, span, -1), stable=True).indices[:B]  # depth ranks
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    selected[sel_pos] = True
    # voxels spanning more than m_small tiles that did not fit the budget: their
    # coverage is cut, and lift_view_splat reports the count
    overflow = ((span >= m_small) & val & ~selected).sum().to(torch.int32)

    def emit(mm, x0_, y0_, x1_, y1_, active):
        di = torch.arange(mm, device=dev)
        txs = x0_[None, :] + di.repeat(mm)[:, None]                  # [mm², ·]
        tys = y0_[None, :] + di.repeat_interleave(mm)[:, None]
        in_rect = (txs <= x1_[None, :]) & (tys <= y1_[None, :]) & active[None, :]
        return torch.where(in_rect, tys * tx_n + txs, num_tiles)

    tid_small = emit(m_small, x0, y0, x1, y1, val & ~selected)       # [ms², N]
    rank = torch.arange(n, device=dev)
    keys_small = ((tid_small << rank_bits) | rank[None, :]).reshape(-1)
    tid_big = emit(m, x0[sel_pos], y0[sel_pos], x1[sel_pos], y1[sel_pos],
                   val[sel_pos])                                     # [m², B]
    keys_big = ((tid_big << rank_bits) | sel_pos[None, :]).reshape(-1)

    skey = torch.sort(torch.cat([keys_small, keys_big])).values
    rank_sorted = skey & ((1 << rank_bits) - 1)
    probes = torch.arange(num_tiles + 1, device=dev) << rank_bits
    offsets = torch.searchsorted(skey, probes).to(torch.int32)
    return order, rank_sorted, offsets, (tx_n, ty_n), overflow


def _splat_candidates(centers, voxel_ids, c2w, intrinsics, voxel_size, depth_max,
                      width: int, height: int, m: int, K: int, pair_cap,
                      dual_bin: bool = True, big_budget: Optional[int] = None) -> dict:
    """Project, bin, and gather each tile's K candidate windows as planar
    [T, K] components (cube low corners wx, wy, wz and voxel ids wid).
    ``pair_cap`` truncates the sorted pair list as the rasterizer's does
    (sentinels sort last, so any cap ≥ the real pair count is exact)."""
    R_c2w = c2w[:3, :3]
    cam_pos = c2w[:3, 3]
    # w2c = [Rᵀ | -Rᵀ·c]; the translation as XLA's dot forms it, term by term
    Rt = R_c2w.T
    w2c = torch.zeros((4, 4), dtype=torch.float32, device=centers.device)
    w2c[:3, :3] = Rt
    w2c[:3, 3] = ((-Rt[:, 0]) * cam_pos[0] + (-Rt[:, 1]) * cam_pos[1]
                  + (-Rt[:, 2]) * cam_pos[2])
    w2c[3, 3] = 1.0

    half = voxel_size * 0.5
    means2d, radius, depth, valid = _project_voxels(centers, half, w2c, intrinsics,
                                                    width, height, depth_max)
    with record_function("lift.binning"):
        if dual_bin:
            order, rank_sorted, offsets, (tx_n, ty_n), overflow = _bin_voxels_dual(
                means2d, radius, depth, valid, width, height, m,
                big_budget or max(centers.shape[0] // 8, 1024))
        else:
            order, rank_sorted, offsets, (tx_n, ty_n) = _bin_voxels(
                means2d, radius, depth, valid, width, height, m)
            overflow = torch.zeros((), dtype=torch.int32, device=centers.device)
        if pair_cap is not None and pair_cap < rank_sorted.shape[0]:
            rank_sorted = rank_sorted[:pair_cap]
            offsets = torch.clamp_max(offsets, pair_cap)

        runs = offsets[1:] - offsets[:-1]
        counts = torch.clamp_max(runs, K)
        # the per-tile K truncation, as rasterize's tile_overflow
        tile_overflow = torch.clamp_min(runs - K, 0).sum()
        slot = torch.arange(K, device=centers.device)
        widx = torch.clamp(offsets[:-1, None].long() + slot[None, :], 0,
                           rank_sorted.shape[0] - 1)                  # [T,K]
        win_vox = order[rank_sorted[widx]]                            # [T,K]
        return dict(counts=counts, wx=(centers[:, 0] - half)[win_vox],
                    wy=(centers[:, 1] - half)[win_vox], wz=(centers[:, 2] - half)[win_vox],
                    wid=voxel_ids[win_vox], tx_n=tx_n, ty_n=ty_n, R_c2w=R_c2w,
                    cam_pos=cam_pos, half=half, bin_overflow=overflow,
                    tile_overflow=tile_overflow)


def _make_tile_best(cand: dict, intrinsics, depth_min: float, depth_max: float,
                    ray_increment, K: int):
    """``tile_best(tile_ids [C])`` → (best [C, 256] argmin slot, any_hit
    [C, 256], ids [C, K]): the per-tile slab test and first march sample."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    R_c2w, cam_pos, half = cand["R_c2w"], cand["cam_pos"], cand["half"]
    counts, tx_n = cand["counts"], cand["tx_n"]
    wx, wy, wz, wid = cand["wx"], cand["wy"], cand["wz"], cand["wid"]
    dev = wx.device

    # per-tile pixel coords (flattened 16×16, row-major like the image)
    pix = torch.arange(TILE, dtype=torch.float32, device=dev)
    pix_x = pix.repeat(TILE)                                         # [256]
    pix_y = pix.repeat_interleave(TILE)
    inc = ray_increment
    ox, oy, oz = cam_pos[0], cam_pos[1], cam_pos[2]
    side = 2.0 * half
    slots = torch.arange(K, device=dev)
    d_min = torch.tensor(depth_min, dtype=torch.float32, device=dev)
    d_max = torch.tensor(depth_max, dtype=torch.float32, device=dev)

    def safe_inv(d):
        tiny = torch.where(d < 0, -1e-9, 1e-9)
        return 1.0 / torch.where(torch.abs(d) < 1e-9, tiny, d)

    @record_function("lift.tile_test")
    def tile_best(tile_ids):
        cnt = counts[tile_ids]                                       # [C]
        bx, by, bz, ids = wx[tile_ids], wy[tile_ids], wz[tile_ids], wid[tile_ids]
        tx = (tile_ids % tx_n).to(torch.float32) * TILE
        ty = torch.div(tile_ids, tx_n, rounding_mode="floor").to(torch.float32) * TILE
        # camera-space dirs, pixel centres at integer coords like the kernel
        dx = (pix_x[None] + tx[:, None] - cx) / fx                   # [C,256]
        dy = (pix_y[None] + ty[:, None] - cy) / fy
        inv_norm = 1.0 / torch.sqrt(dx * dx + dy * dy + 1.0)
        dcx, dcy, dcz = dx * inv_norm, dy * inv_norm, inv_norm
        dwx = R_c2w[0, 0] * dcx + R_c2w[0, 1] * dcy + R_c2w[0, 2] * dcz
        dwy = R_c2w[1, 0] * dcx + R_c2w[1, 1] * dcy + R_c2w[1, 2] * dcz
        dwz = R_c2w[2, 0] * dcx + R_c2w[2, 1] * dcy + R_c2w[2, 2] * dcz
        inv_wn = 1.0 / torch.sqrt(dwx * dwx + dwy * dwy + dwz * dwz)
        dwx, dwy, dwz = dwx * inv_wn, dwy * inv_wn, dwz * inv_wn
        # a tensor numerator: torch forms ``float / tensor`` as a product with
        # the reciprocal, which rounds twice
        t_min = d_min / dcz                                          # [C,256]
        t_end = d_max / dcz

        # slab tests, one [C,K,256] pair per axis
        ix = safe_inv(dwx)[:, None, :]                               # [C,1,256]
        t1 = (bx[:, :, None] - ox) * ix
        t2 = t1 + side * ix
        t_entry = torch.minimum(t1, t2)
        t_exit = torch.maximum(t1, t2)
        iy = safe_inv(dwy)[:, None, :]
        t1 = (by[:, :, None] - oy) * iy
        t2 = t1 + side * iy
        t_entry = torch.maximum(t_entry, torch.minimum(t1, t2))
        t_exit = torch.minimum(t_exit, torch.maximum(t1, t2))
        iz = safe_inv(dwz)[:, None, :]
        t1 = (bz[:, :, None] - oz) * iz
        t2 = t1 + side * iz
        t_entry = torch.maximum(t_entry, torch.minimum(t1, t2))     # [C,K,256]
        t_exit = torch.minimum(t_exit, torch.maximum(t1, t2))

        # first sample of the march grid inside [t_entry, t_exit]
        k = torch.clamp_min(torch.ceil((t_entry - t_min[:, None, :]) / inc), 0.0)
        t_s = t_min[:, None, :] + k * inc
        live = slots[None, :, None] < cnt[:, None, None]
        hit = (t_entry <= t_exit) & (t_s <= t_exit) & live & (t_s < t_end[:, None, :])
        t_s = torch.where(hit, t_s, torch.inf)
        t_best, best = torch.min(t_s, dim=1)                         # [C,256]
        return best, torch.isfinite(t_best), ids

    return tile_best


def first_hit_voxels_splat(centers: torch.Tensor,     # [V,3] world voxel centres
                           voxel_ids: torch.Tensor,   # [V] int32 1-based ids
                           c2w: torch.Tensor, intrinsics: torch.Tensor,
                           voxel_size: torch.Tensor,
                           depth_min: float, depth_max: float,
                           ray_increment: torch.Tensor,
                           width: int, height: int,
                           max_tiles_per_axis: int = 4,
                           max_per_tile: int = 64,
                           tile_chunk: int = TILE_CHUNK,
                           pair_cap: Optional[int] = None,
                           dual_bin: bool = False,
                           big_budget: Optional[int] = None) -> torch.Tensor:
    """Per-pixel first-hit voxel id by splatting, [H, W] int32 (0 = miss).

    ``dual_bin`` defaults to False here, unlike ``lift_view_splat``: this API
    returns only the hit image, so a big-budget overflow would go unseen. The
    per-tile ``max_per_tile`` cap is likewise invisible from the hit image;
    ``lift_view_splat`` reports both."""
    K = max_per_tile
    cand = _splat_candidates(centers, voxel_ids, c2w, intrinsics, voxel_size, depth_max,
                             width, height, max_tiles_per_axis, K, pair_cap, dual_bin,
                             big_budget)
    tile_best = _make_tile_best(cand, intrinsics, depth_min, depth_max, ray_increment, K)
    tx_n, ty_n = cand["tx_n"], cand["ty_n"]
    num_tiles = tx_n * ty_n

    def tile_hits(tile_ids):
        best, any_hit, ids = tile_best(tile_ids)
        return (torch.where(any_hit, ids.gather(1, best), 0),)

    out, = map_tile_chunks(tile_hits, num_tiles, tile_chunk, centers.device)
    return tiles_to_image(out.reshape(num_tiles, TILE, TILE), ty_n, tx_n, height, width)


def lift_view_splat(centers: torch.Tensor, voxel_ids: torch.Tensor,
                    c2w: torch.Tensor, intrinsics: torch.Tensor,
                    voxel_size: torch.Tensor,
                    depth_min: float, depth_max: float,
                    ray_increment: torch.Tensor,
                    features_hwc: torch.Tensor,      # [H,W,C] float
                    num_ids: int, width: int, height: int,
                    max_tiles_per_axis: int = 4,
                    max_per_tile: int = 64,
                    tile_chunk: int = TILE_CHUNK,
                    pair_cap: Optional[int] = None,
                    dual_bin: bool = True,
                    big_budget: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First hit and feature accumulation of one view, fused per tile: each
    tile contracts its pixels' one-hot hit assignment [K, 256] with its feature
    block [256, CH] (``torch.bmm``), and one per-voxel sum over the T·K slots
    merges the candidates' partials. The terms are those of
    ``first_hit_voxels_splat`` + ``scatter_features``, grouped by (tile,
    candidate) instead of raster order.

    Returns (sums [num_ids, C] f32, counts [num_ids] int32, overflow int32
    0-dim): ``overflow`` adds both truncations of this view, big voxels past
    dual_bin's ``big_budget`` and per-tile candidate runs past
    ``max_per_tile``; 0 means no coverage was dropped."""
    K = max_per_tile
    CH = features_hwc.shape[-1]
    dev = centers.device
    cand = _splat_candidates(centers, voxel_ids, c2w, intrinsics, voxel_size, depth_max,
                             width, height, max_tiles_per_axis, K, pair_cap, dual_bin,
                             big_budget)
    tile_best = _make_tile_best(cand, intrinsics, depth_min, depth_max, ray_increment, K)
    tx_n, ty_n = cand["tx_n"], cand["ty_n"]
    num_tiles = tx_n * ty_n
    PX = TILE * TILE

    with record_function("lift.accumulation"):
        fpad = torch.nn.functional.pad(features_hwc.to(torch.float32),
                                       (0, 0, 0, tx_n * TILE - width, 0, ty_n * TILE - height))
        ftiles = (fpad.reshape(ty_n, TILE, tx_n, TILE, CH).transpose(1, 2)
                  .reshape(num_tiles, PX, CH))

    pix = torch.arange(TILE, device=dev)
    pix_xi, pix_yi = pix.repeat(TILE), pix.repeat_interleave(TILE)    # [256]
    slots = torch.arange(K, device=dev)

    def tile_partials(tile_ids):
        best, any_hit, _ = tile_best(tile_ids)                       # [C,256]
        with record_function("lift.accumulation"):
            tx = (tile_ids % tx_n) * TILE
            ty = torch.div(tile_ids, tx_n, rounding_mode="floor") * TILE
            inb = ((pix_xi[None] + tx[:, None] < width)
                   & (pix_yi[None] + ty[:, None] < height))          # [C,256]
            sel = any_hit & inb
            oh = ((slots[None, :, None] == best[:, None, :])
                  & sel[:, None, :]).to(torch.float32)                # [C,K,256]
            part = torch.bmm(oh, ftiles[tile_ids])                    # [C,K,CH]
            return part, oh.sum(dim=2).to(torch.int32)                # [C,K]

    parts, cnts = map_tile_chunks(tile_partials, num_tiles, tile_chunk, dev)
    with record_function("lift.accumulation"):
        seg = cand["wid"].reshape(-1)                                 # [T·K]
        sums = segment_sum(parts.reshape(-1, CH), seg, num_ids)
        counts = segment_sum(cnts.reshape(-1), seg, num_ids)
        # missed pixels are absent here, so row 0 is zeroed for
        # scatter_features' contract
        sums[0] = 0.0
        counts[0] = 0
    return sums, counts, cand["bin_overflow"] + cand["tile_overflow"]
