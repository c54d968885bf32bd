"""N-channel tile rasterizer for 3D Gaussians: project → bin → blend.

Counterpart of segsplat_tpu/ops/rasterize.py. Projection and binning are
ordinary torch ops. The blend has two backends: ``"cuda"``, the counterpart of
the JAX package's ``"pallas"`` — kernel K1 forward and kernel K2 backward
(ops/blend.py), or the packed kernel K3 where ``USE_PACKED`` turns it on — and
``"dense"``, the counterpart of its ``"xla"`` — ``_blend_tiles`` in torch ops,
differentiated by autograd. ``rasterize`` is differentiable in the means,
scales, rotations, opacities, colours, ``means2d_offset`` and bg (except on the
packed branch, which has no backward). Binning (tile membership, depth order,
the K cap) is discrete and carries no gradient.

  1. project: EWA splatting — camera-space means, 2D covariance
     J W Σ Wᵀ Jᵀ + 0.3·I, conic, 3σ radius, in planar [N] components.
  2. bin: Gaussians are depth-sorted (stable), then each emits up to
     max_tiles_per_axis² (tile, depth rank) pairs over its screen AABB; one
     sort of unique int64 keys ``tile << rank_bits | rank`` yields per-tile runs
     in front-to-back order.
  3. blend: the pairs' payload rows, gathered into per-tile runs, are
     composited per 16×16 tile by ``blend``. The pair→Gaussian gradient
     reduction is the autograd of that gather. The dense backend instead
     gathers every tile's K slots and composites them with a cumulative
     product, no early-out, ``tile_chunk`` tiles at a time.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from segsplat_tpu_torch.ops.blend import (PACKED_MAX_CH, _block_alpha, _pixel_centres, blend,
                                          blend_tiles_packed, make_payload, pack_payload)

TILE = 16
BACKENDS = ("cuda", "dense")   # the JAX package's "pallas" and "xla"

# The JAX package's packed blend branch (K3) is switched off by a local
# ``use_packed = False`` (segsplat_tpu/ops/rasterize.py:423-427: on the TPU it
# measured slower than the padded single-pair layout). The port keeps the same
# gate; ``rasterize`` reads it at call time, so a caller may turn it on.
USE_PACKED = False


def map_tile_chunks(tile_fn, num_tiles: int, tile_chunk: int, device):
    """Run ``tile_fn([chunk] tile ids) → tuple of [chunk, ...]`` over all tiles
    in chunks of ``tile_chunk``, the last one shorter. (The JAX package's
    lax.map needs one static chunk shape, so it pads the tail chunk with
    wrapped ids and slices the duplicates off; here that would only repeat
    work.) Returns the tuple with leading dim ``num_tiles``."""
    ids = torch.arange(num_tiles, device=device)
    outs = [tile_fn(chunk) for chunk in ids.split(tile_chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def tiles_to_image(x: torch.Tensor, ty_n: int, tx_n: int, height: int,
                   width: int) -> torch.Tensor:
    """[ty_n·tx_n, TILE, TILE, ...] row-major tile stack → cropped
    [height, width, ...] image."""
    extra = x.shape[3:]
    x = x.reshape((ty_n, tx_n, TILE, TILE) + extra).transpose(1, 2)
    return x.reshape((ty_n * TILE, tx_n * TILE) + extra)[:height, :width]


class Projected(NamedTuple):
    means2d: torch.Tensor   # [N, 2] pixel coords
    depths: torch.Tensor    # [N]
    conics: torch.Tensor    # [N, 3] (a, b, c) of inverse 2D covariance
    radii: torch.Tensor     # [N] float, 3σ screen radius (0 = culled)
    valid: torch.Tensor     # [N] bool


class BlendInputs(NamedTuple):
    offsets: torch.Tensor         # [T+1] int32 per-tile run starts (pair_cap applied)
    sorted_payload: torch.Tensor  # [L+K, W] float32 payload rows in per-tile runs
    tx_n: int
    ty_n: int
    num_pairs: torch.Tensor       # [] real pair count before pair_cap
    tile_overflow: torch.Tensor   # [] pairs beyond the per-tile cap K


def project_gaussians(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                      width: int, height: int, znear: float = 0.2,
                      eps2d: float = 0.3) -> Projected:
    """EWA projection of 3D Gaussians to screen space: cov2d = J W Σ Wᵀ Jᵀ with
    the frustum-clamped Jacobian, plus the 0.3-pixel low-pass. fx..cy are
    floats or 0-dim tensors."""
    R_w2c = viewmat[:3, :3]
    t_cam = means3d @ R_w2c.T + viewmat[:3, 3]
    z = t_cam[:, 2]
    valid = z > znear

    tan_fovx = (0.5 * width) / fx
    tan_fovy = (0.5 * height) / fy

    zc = torch.clamp_min(z, znear)
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.clamp(t_cam[:, 0] / zc, -lim_x, lim_x) * zc
    ty = torch.clamp(t_cam[:, 1] / zc, -lim_y, lim_y) * zc

    qn = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]
    # M = R diag(s); Σ = M Mᵀ (symmetric, 6 unique components)
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    s00 = m00 * m00 + m01 * m01 + m02 * m02
    s01 = m00 * m10 + m01 * m11 + m02 * m12
    s02 = m00 * m20 + m01 * m21 + m02 * m22
    s11 = m10 * m10 + m11 * m11 + m12 * m12
    s12 = m10 * m20 + m11 * m21 + m12 * m22
    s22 = m20 * m20 + m21 * m21 + m22 * m22

    def _wsigma_row(i):
        # (W Σ)ᵢ· as three planar arrays, W = R_w2c
        a = R_w2c[i, 0] * s00 + R_w2c[i, 1] * s01 + R_w2c[i, 2] * s02
        b = R_w2c[i, 0] * s01 + R_w2c[i, 1] * s11 + R_w2c[i, 2] * s12
        c_ = R_w2c[i, 0] * s02 + R_w2c[i, 1] * s12 + R_w2c[i, 2] * s22
        return a, b, c_

    p00, p01, p02 = _wsigma_row(0)
    p10, p11, p12 = _wsigma_row(1)
    p20, p21, p22 = _wsigma_row(2)
    c00 = p00 * R_w2c[0, 0] + p01 * R_w2c[0, 1] + p02 * R_w2c[0, 2]
    c01 = p00 * R_w2c[1, 0] + p01 * R_w2c[1, 1] + p02 * R_w2c[1, 2]
    c02 = p00 * R_w2c[2, 0] + p01 * R_w2c[2, 1] + p02 * R_w2c[2, 2]
    c11 = p10 * R_w2c[1, 0] + p11 * R_w2c[1, 1] + p12 * R_w2c[1, 2]
    c12 = p10 * R_w2c[2, 0] + p11 * R_w2c[2, 1] + p12 * R_w2c[2, 2]
    c22 = p20 * R_w2c[2, 0] + p21 * R_w2c[2, 1] + p22 * R_w2c[2, 2]

    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx·x/z²], [0, fy/z, -fy·y/z²]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + eps2d
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + eps2d

    det = a * c - b * b
    valid = valid & (det > 1e-12)
    det = torch.where(det > 1e-12, det, 1.0)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    u = fx * t_cam[:, 0] * inv_z + cx
    v = fy * t_cam[:, 1] * inv_z + cy
    means2d = torch.stack([u, v], dim=1)

    on_screen = ((u + radius > 0) & (u - radius < width) &
                 (v + radius > 0) & (v - radius < height))
    valid = valid & on_screen
    radius = torch.where(valid, radius, 0.0)
    return Projected(means2d, z, conic, radius, valid)


def bin_gaussian_ranks(proj: Projected, width: int, height: int,
                       max_tiles_per_axis: int,
                       opacities: Optional[torch.Tensor] = None):
    """Depth-sort once, then sort (tile, depth rank) pairs by one unique int64
    key. Pairs outside a Gaussian's tile rectangle get the sentinel tile T and
    sort to the tail.

    ``opacities`` turns on the exact opacity-aware tile cull: a tile whose
    pixel-centre rectangle is farther than d² > 2·ln(255·op)·r²/9 from the
    mean can only give alpha < 1/255.

    Returns (order [N] depth order, rank_sorted [N·m²] depth ranks in per-tile
    runs, offsets [T+1] int32 run starts, (tx_n, ty_n))."""
    dev = proj.means2d.device
    tx_n = -(-width // TILE)
    ty_n = -(-height // TILE)
    num_tiles = tx_n * ty_n
    n = proj.means2d.shape[0]
    m = max_tiles_per_axis

    # stable, as jnp.argsort: invalid Gaussians all share the key inf
    depth_key = torch.where(proj.valid, proj.depths, math.inf)
    order = torch.sort(depth_key, stable=True).indices
    means2d = proj.means2d[order]
    radii = proj.radii[order]
    valid = proj.valid[order]

    # floor → clip → int cast, in that order
    x0 = torch.clamp(torch.floor((means2d[:, 0] - radii) / TILE), 0, tx_n - 1).long()
    y0 = torch.clamp(torch.floor((means2d[:, 1] - radii) / TILE), 0, ty_n - 1).long()
    x1 = torch.clamp(torch.floor((means2d[:, 0] + radii) / TILE), 0, tx_n - 1).long()
    y1 = torch.clamp(torch.floor((means2d[:, 1] + radii) / TILE), 0, ty_n - 1).long()

    di = torch.arange(m, device=dev)
    txs = x0[None, :] + di.repeat(m)[:, None]                      # [m², N]
    tys = y0[None, :] + di.repeat_interleave(m)[:, None]
    in_rect = (txs <= x1[None, :]) & (tys <= y1[None, :]) & valid[None, :]

    if opacities is not None:
        op_s = opacities[order]
        ln_cut = torch.log(torch.clamp_min(255.0 * torch.clamp_max(op_s, 0.999), 1e-12))
        d2_max = (2.0 / 9.0) * ln_cut * radii * radii              # [N]
        # the margin scales with the coordinate magnitude, so float rounding
        # never culls a pair whose true max alpha reaches the 1/255 cutoff
        d2_max = d2_max + 1e-3 + 1e-5 * torch.abs(d2_max)
        rx0 = txs.float() * TILE + 0.5                             # pixel-centre
        ry0 = tys.float() * TILE + 0.5                             # rect bounds
        ddx = torch.clamp_min(torch.maximum(rx0 - means2d[None, :, 0],
                                            means2d[None, :, 0] - (rx0 + TILE - 1.0)), 0.0)
        ddy = torch.clamp_min(torch.maximum(ry0 - means2d[None, :, 1],
                                            means2d[None, :, 1] - (ry0 + TILE - 1.0)), 0.0)
        in_rect = in_rect & (ddx * ddx + ddy * ddy <= d2_max[None, :])

    tile_id = torch.where(in_rect, tys * tx_n + txs, num_tiles)   # sentinel = T
    rank_bits = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    rank = torch.arange(n, device=dev)
    skey = torch.sort(((tile_id << rank_bits) | rank[None, :]).reshape(-1)).values
    rank_sorted = skey & ((1 << rank_bits) - 1)
    probes = torch.arange(num_tiles + 1, device=dev) << rank_bits
    offsets = torch.searchsorted(skey, probes).to(torch.int32)
    return order, rank_sorted, offsets, (tx_n, ty_n)


def tile_depth_counts(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                      width: int, height: int,
                      max_tiles_per_axis: int = 8) -> torch.Tensor:
    """Per-tile pair counts from projection and binning alone, int32 [T]."""
    proj = project_gaussians(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                             width, height)
    _, _, offsets, _ = bin_gaussian_ranks(proj, width, height, max_tiles_per_axis)
    return torch.diff(offsets)


def _bin_gaussians(proj: Projected, width: int, height: int, max_tiles_per_axis: int,
                   opacities: Optional[torch.Tensor] = None):
    """Binning resolved to Gaussian ids: (sorted_gid [N·m²] in per-tile runs,
    offsets [T+1] int32, (tx_n, ty_n)). Binning sees detached values."""
    order, rank_sorted, offsets, dims = bin_gaussian_ranks(
        Projected(*(x.detach() for x in proj)), width, height, max_tiles_per_axis,
        opacities=None if opacities is None else opacities.detach())
    return order[rank_sorted], offsets, dims


def build_blend_inputs(proj: Projected, colors, opacities, width: int, height: int,
                       max_tiles_per_axis: int, max_per_tile: int,
                       pair_cap: Optional[int] = None,
                       opacity_cull: bool = False, packed: bool = False) -> BlendInputs:
    """Bin, then gather the pairs' payload rows into per-tile runs.

    ``pair_cap`` truncates the sorted pair list before the gather: sentinel
    pairs sort to the tail, so any cap ≥ the frame's real pair count is exact.
    On overflow the deepest runs of the highest tile ids are dropped (offsets
    are clamped, so reads stay in bounds). The payload keeps K zero rows past
    the end; with ``packed`` it is K3's [R, 128] layout instead
    (``pack_payload``). Binning sees detached values; the gather carries
    gradients."""
    K = max_per_tile
    sorted_gid, offsets, (tx_n, ty_n) = _bin_gaussians(
        proj, width, height, max_tiles_per_axis,
        opacities=opacities if opacity_cull else None)
    num_pairs = offsets[-1]
    tile_overflow = torch.clamp_min(offsets[1:] - offsets[:-1] - K, 0).sum()
    if pair_cap is not None and pair_cap < sorted_gid.shape[0]:
        sorted_gid = sorted_gid[:pair_cap]
        offsets = torch.clamp_max(offsets, pair_cap)
    rows = make_payload(proj.means2d, proj.conics, opacities, colors)[sorted_gid]
    sorted_payload = (pack_payload(rows, K) if packed
                      else torch.nn.functional.pad(rows, (0, 0, 0, K)))
    return BlendInputs(offsets, sorted_payload, tx_n, ty_n, num_pairs, tile_overflow)


def _blend_tiles(sorted_gid, offsets, proj: Projected, colors, opacities, bg,
                 tx_n: int, ty_n: int, max_per_tile: int, tile_chunk: int = 64):
    """The dense blend (segsplat_tpu/ops/rasterize.py:207-267): every tile's K
    slots gathered from the per-Gaussian arrays, alpha-composited by a
    cumulative product over all K, with no early-out. Each chunk of
    ``tile_chunk`` tiles is checkpointed, as ``jax.checkpoint`` does there, so
    the backward holds one chunk's [C, K, 256] intermediates at a time.

    Alpha deliberately follows the kernels' operation order (``_block_alpha``:
    sigma from ``(a·dx)·dx``), not the JAX dense blend's ``a·(dx·dx)``. So this
    backend matches K1 exactly, and differs from JAX ``backend="xla"`` by
    rounding where a pair-pixel lies at the α ≥ 1/255 cut (2.2e-3 max abs on
    the 1920×1080 headline frame of ``chip_smoke.py``).

    Returns (image [16·ty_n, 16·tx_n, CH], alpha [16·ty_n, 16·tx_n])."""
    K = max_per_tile
    ch = colors.shape[1]
    num_tiles = tx_n * ty_n
    dev = colors.device
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], K)
    slot = torch.arange(K, device=dev)

    def blend_chunk(tile_ids):                                     # [C] tile indices
        start, cnt = off[tile_ids], counts[tile_ids]
        gidx = sorted_gid[torch.clamp(start[:, None] + slot[None, :], 0,
                                      sorted_gid.shape[0] - 1)]     # [C, K]
        live = slot[None, :] < cnt[:, None]
        # the slots' geometry as payload rows: alpha and its cut are then
        # computed as on the kernel path, in the kernels' operation order
        geom = torch.cat([proj.means2d[gidx], proj.conics[gidx],
                          opacities[gidx][..., None]], dim=2)     # [C, K, 6]
        px, py = _pixel_centres(tile_ids, tx_n)
        alpha = _block_alpha(geom, px, py, live)[4]                # [C, K, 256]
        trans = torch.cumprod(1.0 - alpha, dim=1)                  # T after slot
        trans_before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
        img = torch.einsum("ckp,ckh->cph", alpha * trans_before,
                           colors[gidx])                           # [C, 256, CH]
        t_final = trans[:, -1, :]
        return img + t_final[..., None] * bg, 1.0 - t_final

    def chunk_fn(tile_ids):
        if torch.is_grad_enabled():
            return checkpoint(blend_chunk, tile_ids, use_reentrant=False)
        return blend_chunk(tile_ids)

    img, alpha = map_tile_chunks(chunk_fn, num_tiles, tile_chunk, dev)
    h, w = ty_n * TILE, tx_n * TILE
    return (tiles_to_image(img.reshape(num_tiles, TILE, TILE, ch), ty_n, tx_n, h, w),
            tiles_to_image(alpha.reshape(num_tiles, TILE, TILE), ty_n, tx_n, h, w))


def rasterize(means3d, scales, quats, opacities, colors, viewmat, fx, fy, cx, cy,
              width: int, height: int, bg: Optional[torch.Tensor] = None,
              means2d_offset: Optional[torch.Tensor] = None,
              max_tiles_per_axis: int = 8, max_per_tile: int = 512,
              tile_chunk: int = 64, backend: str = "cuda",
              pair_cap: Optional[int] = None, opacity_cull: bool = False) -> dict:
    """Differentiable rasterization on the inputs' device: project → bin → blend.

    colors: [N, CH] per-Gaussian channels. means2d_offset: [N, 2] zeros added to
    the projected means before binning; its gradient is the screen-space mean
    gradient densification consumes. max_per_tile (K) is any positive count
    on both backends. opacity_cull: exact opacity-aware tile culling in
    binning (both backends).

    backend: ``"cuda"`` (the JAX package's ``"pallas"``): kernels K1 forward and
    K2 backward, their plain versions on CPU tensors; ``pair_cap`` (see
    ``build_blend_inputs``) applies to it only. While the module constant
    ``USE_PACKED`` is True and CH ≤ 56 it blends with the packed kernel K3
    instead, which has no backward: that branch raises when grad mode is on and
    an input requires grad. ``"dense"`` (the JAX package's ``"xla"``):
    ``_blend_tiles`` in torch ops, ``tile_chunk`` tiles at a time.

    Returns dict: image [H,W,CH], alpha [H,W], radii [N], visible [N] bool,
    depths [N], tile_overflow (pairs dropped past the per-tile cap K) and
    num_pairs (real pair count before pair_cap), the last two 0-dim tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if bg is None:
        bg = torch.zeros((colors.shape[1],), dtype=colors.dtype, device=colors.device)
    proj = project_gaussians(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                             width, height)
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    K = max_per_tile
    if backend == "dense":
        sorted_gid, offsets, (tx_n, ty_n) = _bin_gaussians(
            proj, width, height, max_tiles_per_axis,
            opacities=opacities if opacity_cull else None)
        num_pairs = offsets[-1]
        tile_overflow = torch.clamp_min(offsets[1:] - offsets[:-1] - K, 0).sum()
        img, alpha = _blend_tiles(sorted_gid, offsets, proj, colors, opacities, bg,
                                  tx_n, ty_n, K, tile_chunk)
    else:
        packed = USE_PACKED and colors.shape[1] <= PACKED_MAX_CH
        if packed and torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in (means3d, scales, quats, opacities, colors, viewmat, bg,
                          means2d_offset, fx, fy, cx, cy)):
            raise RuntimeError("the packed blend (USE_PACKED) has no backward: render "
                               "under torch.no_grad() or with inputs that need no grad")
        inputs = build_blend_inputs(proj, colors, opacities, width, height,
                                    max_tiles_per_axis, K, pair_cap=pair_cap,
                                    opacity_cull=opacity_cull, packed=packed)
        blend_fn = blend_tiles_packed if packed else blend
        img, alpha = blend_fn(inputs.offsets, inputs.sorted_payload, bg,
                              inputs.tx_n, inputs.ty_n, K)
        num_pairs, tile_overflow = inputs.num_pairs, inputs.tile_overflow
    return {
        "image": img[:height, :width],
        "alpha": alpha[:height, :width],
        "radii": proj.radii,
        "visible": proj.valid,
        "depths": proj.depths,
        "num_pairs": num_pairs,
        "tile_overflow": tile_overflow,
    }


def pad_logits_to_channels(logits: torch.Tensor, num_channels: int = 32) -> torch.Tensor:
    """Pad or slice per-Gaussian logits to the fixed raster channel count (the
    reference's NUM_CHANNELS=32 contract)."""
    n, c = logits.shape
    if c < num_channels:
        return torch.nn.functional.pad(logits, (0, num_channels - c))
    return logits[:, :num_channels]
