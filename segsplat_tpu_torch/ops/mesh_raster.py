"""Z-buffered triangle-mesh label rasterization: the ScanNet++ GT renderer of
the mIoU protocol (the reference's debug_checks_scripts/render_scannetpp.py;
README.md:101-103, "GT label maps rendered from the annotated mesh"). The
counterpart of segsplat_tpu/ops/mesh_raster.py, in torch ops on the port's
binning.

Each face is binned like a Gaussian (``ops/rasterize.bin_gaussian_ranks``: its
bounding circle about the vertex centroid, at most ``max_tiles_per_axis``
tiles a side, sorted into per-tile runs of depth order). Per chunk of tiles,
every pixel centre of a tile tests the tile's first K faces with the inclusive
barycentric test (edge functions ≥ 0 in the face's winding), interpolates
1/z perspective-correctly and keeps the nearest face, the first of equal
depths (``torch.argmin``). Faces past a tile's K are counted as overflow.
Z-buffering is a min, so a mesh streams through in face chunks
(``rasterize_mesh_labels_chunked``), each merged into the previous buffers.
No kernel: the JAX package computes this in XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from segsplat_tpu_torch.ops.rasterize import (TILE, Projected, bin_gaussian_ranks,
                                              map_tile_chunks, tiles_to_image)

MISS_LABEL = 255


def _tile_labels(tile_ids, offsets, fidx_sorted, counts, tri, zinv, area2,
                 face_labels, tx_n: int, K: int):
    """Nearest covering face per pixel of the tiles ``tile_ids`` [C]: returns
    (depth [C, 256], +inf where none covers; label [C, 256], MISS_LABEL
    there)."""
    dev = tile_ids.device
    start = offsets[tile_ids].long()
    cnt = counts[tile_ids]
    slot = torch.arange(K, device=dev)
    fidx = fidx_sorted[torch.clamp(start[:, None] + slot[None, :], 0,
                                   fidx_sorted.shape[0] - 1)]      # [C, K]
    live = slot[None, :] < cnt[:, None]
    ax0, ay0 = tri[:, 0, 0][fidx], tri[:, 0, 1][fidx]              # [C, K] each
    ax1, ay1 = tri[:, 1, 0][fidx], tri[:, 1, 1][fidx]
    ax2, ay2 = tri[:, 2, 0][fidx], tri[:, 2, 1][fidx]
    z0, z1, z2 = zinv[:, 0][fidx], zinv[:, 1][fidx], zinv[:, 2][fidx]
    lab = face_labels[fidx]
    a2 = area2[fidx]

    pix = torch.arange(TILE * TILE, device=dev)
    ppx = ((tile_ids % tx_n) * TILE).float()[:, None] + (pix % TILE).float()[None] + 0.5
    ppy = ((tile_ids // tx_n) * TILE).float()[:, None] + (pix // TILE).float()[None] + 0.5

    def edge(ax, ay, bx, by):
        # cross(b - a, p - a) at every pixel: [C, K, 256]
        return ((bx - ax)[:, :, None] * (ppy[:, None, :] - ay[:, :, None])
                - (by - ay)[:, :, None] * (ppx[:, None, :] - ax[:, :, None]))

    e0 = edge(ax1, ay1, ax2, ay2)           # barycentric weight of v0
    e1 = edge(ax2, ay2, ax0, ay0)           # of v1
    e2 = edge(ax0, ay0, ax1, ay1)           # of v2
    s = torch.sign(a2)[:, :, None]
    inside = (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0) & live[:, :, None]
    inv_a2 = torch.where(torch.abs(a2) > 1e-12, 1.0 / a2, 0.0)[:, :, None]
    zinv_pix = (e0 * z0[:, :, None] + e1 * z1[:, :, None] + e2 * z2[:, :, None]) * inv_a2
    depth = torch.where(inside & (zinv_pix > 0), 1.0 / zinv_pix, torch.inf)
    best = torch.argmin(depth, dim=1, keepdim=True)                # [C, 1, 256]
    bd = torch.gather(depth, 1, best)[:, 0]
    bl = torch.gather(lab[:, :, None].expand(depth.shape), 1, best)[:, 0]
    return bd, torch.where(torch.isfinite(bd), bl, MISS_LABEL).to(torch.int32)


def rasterize_mesh_labels(verts: torch.Tensor, faces: torch.Tensor,
                          face_labels: torch.Tensor, viewmat: torch.Tensor,
                          fx, fy, cx, cy, width: int, height: int,
                          max_tiles_per_axis: int = 8, max_per_tile: int = 256,
                          tile_chunk: int = 64, znear: float = 1e-4,
                          depth_init: Optional[torch.Tensor] = None,
                          label_init: Optional[torch.Tensor] = None):
    """Per-pixel face labels with a z-buffer, on the inputs' device. verts
    [V, 3] world, faces [F, 3] int, face_labels [F] int, viewmat [4, 4]
    world→camera.

    Returns (labels [H, W] int32, MISS_LABEL where no face covers; depth
    [H, W] float32, +inf there; overflow, a 0-dim int64 tensor: the face-tile
    pairs dropped past ``max_per_tile``, nonzero meaning some pixels may carry
    a farther face's label or MISS_LABEL). Faces with a vertex at or behind
    ``znear`` are dropped, and a face spanning more than
    ``max_tiles_per_axis`` tiles a side is clipped to that many from its
    corner, as the JAX package clips them. ``depth_init`` and ``label_init``
    merge a previous chunk's z-buffer (nearer wins; the earlier chunk on a
    tie)."""
    # camera coordinates in elementwise ops, not a matrix product: the card
    # and the CPU then round alike, and give the same labels bit for bit
    x, y, z = (verts[:, 0] * viewmat[i, 0] + verts[:, 1] * viewmat[i, 1]
               + verts[:, 2] * viewmat[i, 2] + viewmat[i, 3] for i in range(3))
    zc = torch.clamp_min(z, znear)
    u = fx * x / zc + cx
    v = fy * y / zc + cy
    pts2d = torch.stack([u, v], dim=1)

    faces = faces.long()
    tri = pts2d[faces]                                           # [F, 3, 2]
    triz = z[faces]                                              # [F, 3]
    zinv = 1.0 / torch.clamp_min(triz, znear)                    # perspective-correct
    front = torch.all(triz > znear, dim=1)

    centroid = tri.sum(dim=1) / 3.0                              # [F, 2]
    radius = torch.sqrt(torch.amax(((tri - centroid[:, None, :]) ** 2).sum(-1), dim=1))
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    area2 = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
             - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0]))   # [F]
    valid = front & (torch.abs(area2) > 1e-12)
    on_screen = ((centroid[:, 0] + radius > 0) & (centroid[:, 0] - radius < width)
                 & (centroid[:, 1] + radius > 0) & (centroid[:, 1] - radius < height))
    valid = valid & on_screen
    radius = torch.where(valid, radius, 0.0)

    proj = Projected(means2d=centroid, depths=torch.amin(triz, dim=1),
                     conics=torch.zeros_like(centroid[:, :1]).expand(-1, 3),
                     radii=radius, valid=valid)
    order, rank_sorted, offsets, (tx_n, ty_n) = bin_gaussian_ranks(
        proj, width, height, max_tiles_per_axis)
    fidx_sorted = order[rank_sorted]                             # [L] face per pair
    num_tiles = tx_n * ty_n
    K = max_per_tile
    runs = (offsets[1:] - offsets[:-1]).long()
    counts = torch.clamp_max(runs, K)
    overflow = torch.clamp_min(runs - K, 0).sum()

    labels_dev = face_labels.to(verts.device).long()
    depth_t, label_t = map_tile_chunks(
        lambda ids: _tile_labels(ids, offsets, fidx_sorted, counts, tri, zinv, area2,
                                 labels_dev, tx_n, K),
        num_tiles, tile_chunk, verts.device)
    depth_img = tiles_to_image(depth_t.reshape(num_tiles, TILE, TILE), ty_n, tx_n,
                               height, width)
    label_img = tiles_to_image(label_t.reshape(num_tiles, TILE, TILE), ty_n, tx_n,
                               height, width)
    if depth_init is not None:
        closer = depth_img < depth_init
        label_img = torch.where(closer, label_img, label_init)
        depth_img = torch.minimum(depth_img, depth_init)
    return label_img, depth_img, overflow


def rasterize_mesh_labels_chunked(verts, faces, face_labels, viewmat, fx, fy, cx, cy,
                                  width: int, height: int, face_chunk: int = 262_144,
                                  **kw):
    """Stream a mesh through ``rasterize_mesh_labels`` in chunks of
    ``face_chunk`` faces, merging the z-buffers, so memory stays bounded by a
    chunk's pair table. The tail chunk is not padded (the JAX package pads it
    with zero-area faces for one compiled shape, which its validity test
    drops). Returns (labels, depth, overflow summed over the chunks)."""
    dev = verts.device
    faces = torch.as_tensor(faces, device=dev)
    face_labels = torch.as_tensor(face_labels, device=dev)
    depth = torch.full((height, width), torch.inf, dtype=torch.float32, device=dev)
    label = torch.full((height, width), MISS_LABEL, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, faces.shape[0], face_chunk):
        label, depth, of = rasterize_mesh_labels(
            verts, faces[s:s + face_chunk], face_labels[s:s + face_chunk], viewmat,
            fx, fy, cx, cy, width, height, depth_init=depth, label_init=label, **kw)
        overflow = overflow + of
    return label, depth, overflow
