"""N-channel tile rasterizer for 3D Gaussians: project → bin → blend.

Counterpart of segsplat_tpu/ops/rasterize.py. Projection is one hand-written
CUDA kernel (csrc/project.cu) where nothing differentiates or compiles it, else
ordinary torch ops, with the same bits; binning is ordinary torch ops. The
blend has two backends: ``"cuda"``, the counterpart of
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

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from segsplat_tpu_torch.ops.blend import (PACKED_MAX_CH, _block_alpha, _pixel_centres, blend,
                                          blend_tiles_packed, make_payload, pack_payload)
from segsplat_tpu_torch.utils import cuda_build
from segsplat_tpu_torch.utils.profiling import annotate, count

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
                      eps2d: float = 0.3, tan_fovx=None, tan_fovy=None,
                      row0: int = 0) -> Projected:
    """EWA projection of 3D Gaussians to screen space: cov2d = J W Σ Wᵀ Jᵀ with
    the frustum-clamped Jacobian, plus the 0.3-pixel low-pass. fx..cy are
    floats or 0-dim tensors. The Jacobian's frustum clamp is 1.3·tan_fov,
    with tan_fovx = 0.5·width/fx and tan_fovy = 0.5·height/fy unless given.

    A strip of a taller frame passes the frame's tan-FoV and cy, and ``row0``,
    its first row (a multiple of 16): the means are then the frame's less
    row0, which is exact, so the strip's pixel offsets are the frame's bits.

    Where nothing differentiates or traces the call and the Gaussians are on
    the card, it launches the kernel ``csrc/project.cu``, which counts in
    ``project_gaussians.launches`` and gives the plain version's bits; on
    the card, an input the kernel cannot read (not float32, another device or
    shape, a tensor subclass) raises ValueError there rather than taking the
    plain version. The intrinsics and tan-FoVs may be 0-dim tensors on the
    card, Python or NumPy numbers, or 0-dim CPU tensors. Everywhere else
    (the CPU, training's differentiable renders, the compiled frame) it runs
    ``project_gaussians_plain``."""
    args = (means3d, scales, quats, viewmat, fx, fy, cx, cy, width, height, znear, eps2d,
            tan_fovx, tan_fovy, row0)
    if _kernel_takes(means3d, (scales, quats, viewmat, fx, fy, cx, cy, tan_fovx, tan_fovy)):
        out = _project_on_card(*args)
        project_gaussians.launches += 1
        return out
    return project_gaussians_plain(*args)


project_gaussians.launches = 0


def _on_card(means3d) -> bool:
    """Whether the Gaussians are on the card (the CPU tests stand it in)."""
    return means3d.is_cuda


def _kernel_takes(means3d, others) -> bool:
    """Whether ``project_gaussians`` launches the kernel: not under a
    torch.compile or torch.export trace (Inductor fuses the plain version
    there, and a fake tensor has no memory), the Gaussians on the card, and
    nothing for autograd to record (the kernel has no backward)."""
    if torch.compiler.is_compiling() or not _on_card(means3d):
        return False
    return not (torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in (means3d,) + others))


def _card_tensor(x, name: str, dev, shape) -> None:
    """Raise ValueError unless ``x`` is a plain float32 tensor (or a
    Parameter) of ``shape`` on ``dev``, as the kernel reads it."""
    if (type(x) not in (torch.Tensor, torch.nn.Parameter) or x.dtype != torch.float32
            or x.device != dev or tuple(x.shape) != tuple(shape)):
        got = (f"{type(x).__name__} {x.dtype} {tuple(x.shape)} on {x.device}"
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(f"project_gaussians: the projection kernel reads {name} as a "
                         f"float32 tensor of shape {tuple(shape)} on {dev}; got {got}")


def _card_scalar(x, name: str, dev):
    """(pointer, value) of a scalar for the kernel: a tensor on the card
    (0-dim float32 on ``dev``, else ValueError) by pointer, so the host never
    waits; a Python or NumPy number or a 0-dim CPU tensor by its value."""
    if isinstance(x, torch.Tensor) and (x.is_cuda or x.dim() != 0):
        _card_tensor(x, name, dev, ())
        return x.data_ptr(), 0.0
    return None, float(x)


def _frustum_lim(tan_fov, f, half_extent: float, dev):
    """(mode, pointer, value) of one axis's frustum limit 1.3·tan_fov for the
    kernel, reckoned as the plain version does: 1, a tan_fov tensor on the
    card; 2, no tan_fov and a focal tensor f on the card (checked with the
    intrinsics), (1 / f)·half_extent there; 0, else the plain version's own
    expression, reckoned here on the host and passed by value."""
    if isinstance(tan_fov, torch.Tensor) and tan_fov.is_cuda:
        return 1, _card_scalar(tan_fov, "tan_fov", dev)[0], 0.0
    if tan_fov is None and isinstance(f, torch.Tensor) and f.is_cuda:
        return 2, f.data_ptr(), half_extent
    lim = 1.3 * ((half_extent / f) if tan_fov is None else tan_fov)
    return 0, None, _card_scalar(lim, "the frustum limit", dev)[1]


@functools.cache
def _project_fn():
    """The C entry point ``segsplat_project`` of ``csrc/project.cu``."""
    fn = cuda_build.load_library("project").segsplat_project
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([P] * 5 + [I, I] + [P] * 4 + [F] * 4 + [I, I, P, P, F, F] + [F] * 5
                   + [P] * 5 + [ctypes.c_longlong, P])
    fn.restype = ctypes.c_int
    return fn


def _launch(dev, *args) -> None:
    """``segsplat_project(*args)`` on ``dev``'s current stream."""
    with torch.cuda.device(dev):
        err = _project_fn()(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"project kernel launch failed: cudaError {err}")


def _project_on_card(means3d, scales, quats, viewmat, fx, fy, cx, cy, width, height,
                     znear, eps2d, tan_fovx, tan_fovy, row0) -> Projected:
    """Check the inputs and launch ``csrc/project.cu``. The camera-space means
    (a cuBLAS product) and the quaternions' norms (a PyTorch reduction) run
    first, as the plain version runs them: the kernel cannot reproduce their
    library's rounding, so it reads them."""
    dev = means3d.device
    n = means3d.shape[0] if means3d.dim() else 0
    for x, name, shape in ((means3d, "means3d", (n, 3)), (scales, "scales", (n, 3)),
                           (quats, "quats", (n, 4)), (viewmat, "viewmat", (4, 4))):
        _card_tensor(x, name, dev, shape)
    intr = [_card_scalar(x, name, dev) for x, name in ((fx, "fx"), (fy, "fy"),
                                                       (cx, "cx"), (cy, "cy"))]
    lx = _frustum_lim(tan_fovx, fx, 0.5 * width, dev)
    ly = _frustum_lim(tan_fovy, fy, 0.5 * height, dev)
    R_w2c = viewmat[:3, :3]
    t_cam = (means3d @ R_w2c.T + viewmat[:3, 3]).contiguous()
    qnorm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    scales, quats = scales.contiguous(), quats.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    means2d, depths = torch.empty((n, 2), **f32), torch.empty((n,), **f32)
    conics, radii = torch.empty((n, 3), **f32), torch.empty((n,), **f32)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    _launch(dev, t_cam.data_ptr(), qnorm.data_ptr(), scales.data_ptr(), quats.data_ptr(),
            viewmat.data_ptr(), viewmat.stride(0), viewmat.stride(1),
            *(p for p, _ in intr), *(v for _, v in intr),
            lx[0], ly[0], lx[1], ly[1], lx[2], ly[2], float(znear), float(eps2d), row0,
            width, height, means2d.data_ptr(), depths.data_ptr(), conics.data_ptr(),
            radii.data_ptr(), valid.data_ptr(), n)
    return Projected(means2d, depths, conics, radii, valid)


def project_gaussians_plain(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                            width: int, height: int, znear: float = 0.2,
                            eps2d: float = 0.3, tan_fovx=None, tan_fovy=None,
                            row0: int = 0) -> Projected:
    """``project_gaussians`` in eager PyTorch operators, differentiable: every
    call on the CPU, under autograd or in a compiled trace; the kernel's
    yardstick, bit for bit."""
    R_w2c = viewmat[:3, :3]
    t_cam = means3d @ R_w2c.T + viewmat[:3, 3]
    z = t_cam[:, 2]
    valid = z > znear

    if tan_fovx is None:
        tan_fovx = (0.5 * width) / fx
    if tan_fovy is None:
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
    if row0:
        v = v - row0
    means2d = torch.stack([u, v], dim=1)

    on_screen = ((u + radius > 0) & (u - radius < width) &
                 (v + radius > 0) & (v - radius < height))
    valid = valid & on_screen
    radius = torch.where(valid, radius, 0.0)
    return Projected(means2d, z, conic, radius, valid)


def bin_gaussian_ranks(proj: Projected, width: int, height: int,
                       max_tiles_per_axis: int,
                       opacities: Optional[torch.Tensor] = None, tile_row0: int = 0):
    """Depth-sort once, then sort (tile, depth rank) pairs by one unique int64
    key. Pairs outside a Gaussian's tile rectangle get the sentinel tile T and
    sort to the tail.

    ``opacities`` turns on the exact opacity-aware tile cull: a tile whose
    pixel-centre rectangle is farther than d² > 2·ln(255·op)·r²/9 from the
    mean can only give alpha < 1/255.

    ``tile_row0`` > 0 bins a strip whose first tile row is that row of a taller
    frame: a Gaussian's m tile rows count from its top row in the frame, not in
    the strip, so a Gaussian that the cap truncates keeps the frame's tiles.

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
    y0 = torch.clamp(torch.floor((means2d[:, 1] - radii) / TILE), -tile_row0, ty_n - 1).long()
    x1 = torch.clamp(torch.floor((means2d[:, 0] + radii) / TILE), 0, tx_n - 1).long()
    y1 = torch.clamp(torch.floor((means2d[:, 1] + radii) / TILE), 0, ty_n - 1).long()

    di = torch.arange(m, device=dev)
    txs = x0[None, :] + di.repeat(m)[:, None]                      # [m², N]
    tys = y0[None, :] + di.repeat_interleave(m)[:, None]
    in_rect = (txs <= x1[None, :]) & (tys >= 0) & (tys <= y1[None, :]) & valid[None, :]

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
                   opacities: Optional[torch.Tensor] = None, tile_row0: int = 0):
    """Binning resolved to Gaussian ids: (sorted_gid [N·m²] in per-tile runs,
    offsets [T+1] int32, (tx_n, ty_n)). Binning sees detached values."""
    order, rank_sorted, offsets, dims = bin_gaussian_ranks(
        Projected(*(x.detach() for x in proj)), width, height, max_tiles_per_axis,
        opacities=None if opacities is None else opacities.detach(), tile_row0=tile_row0)
    return order[rank_sorted], offsets, dims


def _pair_counts(offsets: torch.Tensor, K: int):
    """The real pairs of the tile runs and those past the per-tile cap K, 0-dim
    tensors, also given as the counts ``pairs`` and ``pairs_past_k`` of the
    open span (no host sync)."""
    num_pairs = offsets[-1]
    tile_overflow = torch.clamp_min(offsets[1:] - offsets[:-1] - K, 0).sum()
    count("pairs", num_pairs)
    count("pairs_past_k", tile_overflow)
    return num_pairs, tile_overflow


def build_blend_inputs(proj: Projected, colors, opacities, width: int, height: int,
                       max_tiles_per_axis: int, max_per_tile: int,
                       pair_cap: Optional[int] = None,
                       opacity_cull: bool = False, packed: bool = False,
                       tile_row0: int = 0) -> BlendInputs:
    """Bin, then gather the pairs' payload rows into per-tile runs.

    ``pair_cap`` truncates the sorted pair list before the gather: sentinel
    pairs sort to the tail, so any cap ≥ the frame's real pair count is exact.
    On overflow the deepest runs of the highest tile ids are dropped (offsets
    are clamped, so reads stay in bounds). The payload keeps K zero rows past
    the end; with ``packed`` it is K3's [R, 128] layout instead
    (``pack_payload``). ``tile_row0``: see ``bin_gaussian_ranks``. Binning
    sees detached values; the gather carries gradients. Runs in the spans
    ``raster.bin`` (binning, the counts, the cap; it counts ``pairs`` and
    ``pairs_past_k``, device values) and ``raster.gather`` (it counts
    ``rows``, the payload rows gathered before the pad)."""
    K = max_per_tile
    with annotate("raster.bin"):
        sorted_gid, offsets, (tx_n, ty_n) = _bin_gaussians(
            proj, width, height, max_tiles_per_axis,
            opacities=opacities if opacity_cull else None, tile_row0=tile_row0)
        num_pairs, tile_overflow = _pair_counts(offsets, K)
        if pair_cap is not None and pair_cap < sorted_gid.shape[0]:
            sorted_gid = sorted_gid[:pair_cap]
            offsets = torch.clamp_max(offsets, pair_cap)
    with annotate("raster.gather"):
        count("rows", sorted_gid.shape[0])
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
              pair_cap: Optional[int] = None, opacity_cull: bool = False,
              tan_fovx=None, tan_fovy=None, tile_row0: int = 0) -> dict:
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

    The stages run in spans (``utils/profiling.annotate``): ``raster.project``
    (with the offset's add), ``raster.bin`` (counting ``pairs`` and
    ``pairs_past_k``), ``raster.gather`` (the kernel path's payload rows,
    counting ``rows``; the dense blend gathers inside its chunks) and
    ``raster.blend`` (the blend's op dispatch and launch on the card).

    tile_row0 > 0: the image is ``height`` rows of a taller frame from its
    tile row tile_row0 on (``parallel/render.rasterize_strip``); cx, cy are
    the frame's, and tan_fovx, tan_fovy its frustum clamp's
    (``project_gaussians``), which default to this image's; the binning
    counts the tile cap from the frame's rows (``bin_gaussian_ranks``).

    Returns dict: image [H,W,CH], alpha [H,W], radii [N], visible [N] bool,
    depths [N], tile_overflow (pairs dropped past the per-tile cap K) and
    num_pairs (real pair count before pair_cap), the last two 0-dim tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if bg is None:
        bg = torch.zeros((colors.shape[1],), dtype=colors.dtype, device=colors.device)
    with annotate("raster.project"):
        proj = project_gaussians(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                                 width, height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                                 row0=tile_row0 * TILE)
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset)
    K = max_per_tile
    if backend == "dense":
        with annotate("raster.bin"):
            sorted_gid, offsets, (tx_n, ty_n) = _bin_gaussians(
                proj, width, height, max_tiles_per_axis,
                opacities=opacities if opacity_cull else None, tile_row0=tile_row0)
            num_pairs, tile_overflow = _pair_counts(offsets, K)
        with annotate("raster.blend"):
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
                                    opacity_cull=opacity_cull, packed=packed,
                                    tile_row0=tile_row0)
        blend_fn = blend_tiles_packed if packed else blend
        with annotate("raster.blend"):
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
