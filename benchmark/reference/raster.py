"""Plain PyTorch reference of the tile rasterizer: pinhole camera, EWA
projection, binning with the per-axis tile cap m and the per-tile cap K, and
the front-to-back blend of 16×16 tiles. It imports nothing of the program.

The semantics are those the program states for its ``rasterize`` (3D Gaussian
Splatting's, arXiv 2308.04079, with the port's caps):

  * projection: camera-space means, cov2d = J W Σ Wᵀ Jᵀ + 0.3·I with the
    Jacobian's frustum clamp at 1.3·tan(fov/2), culled at z ≤ 0.2, a 3σ radius
    ceil(3·sqrt(λ₁)) and an on-screen test;
  * binning: Gaussians stably sorted by depth; each emits the tiles of its
    screen rectangle, at most m per axis counted from its top-left tile; a tile
    keeps its first K Gaussians in depth order;
  * blend: pixel centres at +0.5, sigma = ½(a·dx² + c·dy²) + b·dx·dy,
    alpha = min(op·e^-sigma, 0.999), a pair-pixel counts where sigma ≥ 0 and
    alpha ≥ 1/255, an early-out at blocks of G rows (G = 256 where K is a
    multiple of 256, else 128) once every pixel of the tile is below 1e-4, and
    the background weighted by the final transmittance.

The projection's formulas are written in the order the program evaluates
them, so that both sides put the same Gaussian in the same tile: a rounding
difference at a tile edge would move a whole Gaussian. The blend composites
with a cumulative product, not the kernels' running product. ``blend_dtype``
computes the blend's weights, colours and sum in another precision (the
control uses bfloat16); geometry and the cut stay in float32.

``blend`` also counts the work the blend kernels need on these inputs (rows
read, pair-pixels that pass the cut), which the roofline readers use.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
PX = TILE * TILE
SAT_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999


def no_tf32() -> None:
    """float32 matrix products in float32: the reference is plain float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Cam(NamedTuple):
    viewmat: torch.Tensor    # [4, 4] world → view
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int


def pinhole(R: torch.Tensor, T: torch.Tensor, fov_x: float, fov_y: float,
            width: int, height: int) -> Cam:
    """The reference's camera convention: R camera-to-world, T world-to-camera,
    W2C = [[Rᵀ, T], [0, 1]], principal point at the centre, focal lengths from
    the fields of view (float32 on R's device)."""
    dev = R.device
    w2c = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = T
    w2c[3, 3] = 1.0
    fx = width / (2.0 * torch.tan(torch.tensor(fov_x, dtype=torch.float32, device=dev) * 0.5))
    fy = height / (2.0 * torch.tan(torch.tensor(fov_y, dtype=torch.float32, device=dev) * 0.5))
    K = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    K[0, 0], K[1, 1] = fx, fy
    K[0, 2], K[1, 2] = width / 2.0, height / 2.0
    return Cam(w2c, K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height)


class Projected(NamedTuple):
    means2d: torch.Tensor   # [N, 2]
    depths: torch.Tensor    # [N]
    conics: torch.Tensor    # [N, 3]
    radii: torch.Tensor     # [N]
    valid: torch.Tensor     # [N] bool


def project(means3d, scales, quats, cam: Cam, znear: float = 0.2,
            eps2d: float = 0.3) -> Projected:
    """EWA projection (differentiable in means3d, scales and quats)."""
    viewmat, fx, fy, cx, cy = cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy
    width, height = cam.width, cam.height
    W = viewmat[:3, :3]
    t = means3d @ W.T + viewmat[:3, 3]
    z = t[:, 2]
    valid = z > znear
    tan_x, tan_y = (0.5 * width) / fx, (0.5 * height) / fy
    zc = torch.clamp_min(z, znear)
    lim_x, lim_y = 1.3 * tan_x, 1.3 * tan_y
    tx = torch.clamp(t[:, 0] / zc, -lim_x, lim_x) * zc
    ty = torch.clamp(t[:, 1] / zc, -lim_y, lim_y) * zc

    q = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, zq = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = [[1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq), 2 * (x * zq + w * y)],
           [2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - w * x)],
           [2 * (x * zq - w * y), 2 * (y * zq + w * x), 1 - 2 * (x * x + y * y)]]
    s = [scales[:, 0], scales[:, 1], scales[:, 2]]
    M = [[rot[i][j] * s[j] for j in range(3)] for i in range(3)]       # R diag(s)

    def sig(i, j):                                                     # (M Mᵀ)ij
        return M[i][0] * M[j][0] + M[i][1] * M[j][1] + M[i][2] * M[j][2]

    S = {(i, j): sig(i, j) for i in range(3) for j in range(i, 3)}
    Sf = lambda i, j: S[(min(i, j), max(i, j))]
    P = [[W[i, 0] * Sf(0, j) + W[i, 1] * Sf(1, j) + W[i, 2] * Sf(2, j) for j in range(3)]
         for i in range(3)]                                            # W Σ

    def cov(i, j):                                                     # (W Σ Wᵀ)ij
        return P[i][0] * W[j, 0] + P[i][1] * W[j, 1] + P[i][2] * W[j, 2]

    c00, c01, c02, c11, c12, c22 = cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1), cov(1, 2), cov(2, 2)
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + eps2d
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + eps2d
    det = a * c - b * b
    valid = valid & (det > 1e-12)
    det = torch.where(det > 1e-12, det, 1.0)
    inv_det = 1.0 / det
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    u = fx * t[:, 0] * inv_z + cx
    v = fy * t[:, 1] * inv_z + cy
    on_screen = (u + radius > 0) & (u - radius < width) & (v + radius > 0) & (v - radius < height)
    valid = valid & on_screen
    return Projected(torch.stack([u, v], dim=1), z, conics, torch.where(valid, radius, 0.0), valid)


class Bins(NamedTuple):
    gid: torch.Tensor       # [pairs] Gaussian ids in per-tile runs, depth order
    offsets: torch.Tensor   # [T + 1] int64 run starts
    tx_n: int
    ty_n: int


def bin_tiles(proj: Projected, width: int, height: int, m: int) -> Bins:
    """Per-tile runs of Gaussian ids in depth order (no gradient)."""
    dev = proj.means2d.device
    tx_n, ty_n = -(-width // TILE), -(-height // TILE)
    T = tx_n * ty_n
    n = proj.depths.shape[0]
    order = torch.sort(torch.where(proj.valid, proj.depths, math.inf).detach(), stable=True).indices
    mu, r, ok = proj.means2d.detach()[order], proj.radii.detach()[order], proj.valid[order]
    x0 = torch.clamp(torch.floor((mu[:, 0] - r) / TILE), 0, tx_n - 1).long()
    y0 = torch.clamp(torch.floor((mu[:, 1] - r) / TILE), 0, ty_n - 1).long()
    x1 = torch.clamp(torch.floor((mu[:, 0] + r) / TILE), 0, tx_n - 1).long()
    y1 = torch.clamp(torch.floor((mu[:, 1] + r) / TILE), 0, ty_n - 1).long()
    step = torch.arange(m, device=dev)
    xs = x0[:, None] + step                                         # [N, m]
    ys = y0[:, None] + step
    live = (ok[:, None, None] & (ys <= y1[:, None])[:, :, None]
            & (xs <= x1[:, None])[:, None, :])                      # [N, m(y), m(x)]
    tile = ys[:, :, None] * tx_n + xs[:, None, :]
    rank = torch.arange(n, device=dev)[:, None, None].expand_as(tile)
    key = torch.sort(tile[live] * n + rank[live]).values            # tile-major, depth-minor
    tile_of = key // n
    offsets = torch.searchsorted(tile_of, torch.arange(T + 1, device=dev))
    return Bins(order[key % n], offsets, tx_n, ty_n)


def g_block(K: int) -> int:
    return 256 if K % 256 == 0 else 128


def _pixel_centres(tiles: torch.Tensor, tx_n: int):
    pid = torch.arange(PX, device=tiles.device)
    px = ((tiles % tx_n)[:, None] * TILE + pid % TILE).float() + 0.5
    py = ((tiles // tx_n)[:, None] * TILE + pid // TILE).float() + 0.5
    return px[:, None, :], py[:, None, :]                           # [C, 1, PX]


def _alpha(rows: torch.Tensor, px, py, live):
    """rows [C, K, 6] (mu_x, mu_y, a, b, c, op) → alpha [C, K, PX], 0 where
    the cut fails; float32, in the order the program states sigma."""
    dx = rows[..., 0:1] - px
    dy = rows[..., 1:2] - py
    a, b, c, op = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5], rows[..., 5:6]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp_max(op * torch.exp(-sigma), ALPHA_MAX)
    ok = (sigma >= 0.0) & (alpha >= ALPHA_MIN) & live[..., None]
    return torch.where(ok, alpha, 0.0), ok


def _composite(alpha, colors, bg, G: int, dtype):
    """Front-to-back sum over the K slots, in G-row blocks with the early-out.
    Returns (image [C, PX, CH], rows-read mask [C, K])."""
    C, K, _ = alpha.shape
    trans = torch.ones((C, PX), dtype=dtype, device=alpha.device)
    img = torch.zeros((C, PX, colors.shape[-1]), dtype=dtype, device=alpha.device)
    read = torch.zeros((C, K), dtype=torch.bool, device=alpha.device)
    for b0 in range(0, K, G):
        going = (trans >= SAT_EPS).any(-1) if b0 else torch.ones(C, dtype=torch.bool,
                                                                 device=alpha.device)
        a = alpha[:, b0:b0 + G].to(dtype) * going[:, None, None].to(dtype)
        cum = torch.cumprod(1.0 - a, dim=1)
        before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = a * before * trans[:, None, :]
        img = img + torch.einsum("ckp,ckh->cph", w, colors[:, b0:b0 + G].to(dtype))
        trans = trans * cum[:, -1]
        read[:, b0:b0 + G] = going[:, None]
    return img + trans[..., None] * bg.to(dtype), read


def blend(proj: Projected, opac: torch.Tensor, colors: torch.Tensor, bg: torch.Tensor,
          bins: Bins, K: int, *, blend_dtype=torch.float32, chunk: int = 256,
          work: Optional[dict] = None, image: bool = True):
    """The image [H, W, CH] of the binned Gaussians (differentiable in the
    projection, opacities and colours; chunks are checkpointed under grad).
    With a dict ``work`` it adds the counts the blend kernels need:
    ``rows_fwd`` (rows the forward reads, with its early-out), ``hits_fwd``
    (their pair-pixels that pass the cut), ``rows_bwd`` and ``hits_bwd``
    (every row up to the cap), ``pairs`` and ``tiles``. ``image=False`` only
    counts."""
    dev = colors.device
    T = bins.tx_n * bins.ty_n
    gid, off = bins.gid, bins.offsets
    counts = torch.clamp_max(off[1:] - off[:-1], K)
    slot = torch.arange(K, device=dev)
    G = g_block(K)
    geom = torch.cat([proj.means2d, proj.conics, opac[:, None]], dim=1)   # [N, 6]
    last = max(gid.shape[0] - 1, 0)
    safe_gid = gid if gid.numel() else torch.zeros(1, dtype=torch.long, device=dev)

    def tiles_part(tiles):
        live = slot[None, :] < counts[tiles, None]
        g = safe_gid[torch.clamp(off[tiles, None] + slot[None, :], 0, last)]
        px, py = _pixel_centres(tiles, bins.tx_n)
        alpha, ok = _alpha(geom[g], px, py, live)
        img, read = _composite(alpha, colors[g], bg, G, blend_dtype)
        return img.to(colors.dtype), ok, read & live

    outs = []
    for tiles in torch.arange(T, device=dev).split(chunk):
        if work is not None:
            with torch.no_grad():
                _, ok, read = tiles_part(tiles)
                work["rows_fwd"] = work.get("rows_fwd", 0) + int(read.sum())
                work["hits_fwd"] = work.get("hits_fwd", 0) + int((ok & read[..., None]).sum())
                work["rows_bwd"] = work.get("rows_bwd", 0) + int(counts[tiles].sum())
                work["hits_bwd"] = work.get("hits_bwd", 0) + int(ok.sum())
        if not image:
            continue
        if torch.is_grad_enabled():
            outs.append(checkpoint(lambda t: tiles_part(t)[0], tiles, use_reentrant=False))
        else:
            outs.append(tiles_part(tiles)[0])
    if work is not None:
        work["pairs"] = work.get("pairs", 0) + int(off[-1])
        work["tiles"] = work.get("tiles", 0) + T
    if not image:
        return None
    img = torch.cat(outs).reshape(bins.ty_n, bins.tx_n, TILE, TILE, -1).transpose(1, 2)
    return img.reshape(bins.ty_n * TILE, bins.tx_n * TILE, -1)


def render(means3d, scales, quats, opac, colors, bg, cam: Cam, m: int, K: int, **kw):
    """project → bin → blend: the image [H, W, CH] cropped to the camera."""
    proj = project(means3d, scales, quats, cam)
    bins = bin_tiles(proj, cam.width, cam.height, m)
    img = blend(proj, opac, colors, bg, bins, K, **kw)
    return None if img is None else img[:cam.height, :cam.width]
