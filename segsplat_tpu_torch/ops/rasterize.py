"""N-channel tile rasterizer for 3D Gaussians: project → bin → blend.

Counterpart of segsplat_tpu/ops/rasterize.py. Projection is a hand-written
CUDA kernel (csrc/project.cu) on the card, under autograd a forward and
backward pair, where no compile traces it and the camera needs no gradient;
else ordinary torch ops, with the forward's bits. Binning is ordinary torch
ops. The blend has two backends: ``"cuda"``, the counterpart of the JAX package's
``"pallas"`` — kernel K1 forward and kernel K2 backward (ops/blend.py) — and
``"dense"``, the counterpart of its ``"xla"`` — ``_blend_tiles`` in torch ops,
differentiated by autograd. ``rasterize`` is differentiable in the means,
scales, rotations, opacities, colours, ``means2d_offset`` and bg. Binning
(tile membership, depth order, the K cap) is discrete and carries no
gradient. The packed kernel K3 (``blend_tiles_packed``) takes no route here,
as the JAX package's ``use_packed = False`` takes none there: a caller that
wants it packs the gathered rows with ``pack_payload``.

  1. project: EWA splatting — camera-space means, 2D covariance
     J W Σ Wᵀ Jᵀ + 0.3·I, conic, 3σ radius, in planar [N] components.
  2. bin: Gaussians are depth-sorted (stable), then each emits up to
     max_tiles_per_axis² (tile, depth rank) pairs over its screen AABB; one
     sort of unique int64 keys ``tile << rank_bits | rank`` yields per-tile runs
     in front-to-back order.
  3. blend: the pairs' payload rows, gathered into per-tile runs, are
     composited per 16×16 tile by ``blend``. The pair→Gaussian gradient
     reduction is the autograd of that gather. Where nothing needs a
     gradient on the card, no such gather is built: K1's indexed variant
     fetches each pair's row from a per-Gaussian table through its depth
     rank (``blend_tiles_indexed``), with the same bits. The dense backend
     instead gathers every tile's K slots and composites them with a cumulative
     product, no early-out, ``tile_chunk`` tiles at a time.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from segsplat_tpu_torch.ops.blend import (_block_alpha, _pixel_centres, blend,
                                          blend_tiles_indexed, make_payload)
from segsplat_tpu_torch.utils import cuda_build
from segsplat_tpu_torch.utils.profiling import annotate, count

TILE = 16
BACKENDS = ("cuda", "dense")   # the JAX package's "pallas" and "xla"


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


class Binned(NamedTuple):
    order: torch.Tensor           # [N] depth order
    rank_sorted: torch.Tensor     # [L] depth ranks in per-tile runs (pair_cap applied)
    offsets: torch.Tensor         # [T+1] int32 per-tile run starts (pair_cap applied)
    tx_n: int
    ty_n: int
    num_pairs: torch.Tensor       # [] real pair count before pair_cap
    tile_overflow: torch.Tensor   # [] pairs beyond the per-tile cap K


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

    Where the Gaussians are on the card and no compile or export trace runs,
    it launches the kernel ``csrc/project.cu``, which counts in
    ``project_gaussians.launches`` and gives the plain version's bits. Where
    autograd records the Gaussians (means3d, scales or quats need grad), the
    launch is the forward of a ``torch.autograd.Function`` whose backward is
    the kernel's twin ``segsplat_project_bwd`` (``backward_launches``), the
    bits of ``project_gaussians_vjp_plain``. That backward gives the
    Gaussians' gradients alone, none to the camera. On the card, an input the
    kernel cannot read raises ValueError rather than take the plain version:
    one not float32, on another device or of another shape, a tensor
    subclass, or, under grad mode, a camera input (viewmat, the intrinsics,
    the tan-FoVs) that needs grad. The intrinsics and tan-FoVs may be 0-dim
    tensors on the card, Python or NumPy numbers, or 0-dim CPU tensors.
    Everywhere else (the CPU, the compiled frame) it runs
    ``project_gaussians_plain``."""
    args = (means3d, scales, quats, viewmat, fx, fy, cx, cy, width, height, znear, eps2d,
            tan_fovx, tan_fovy, row0)
    if _card_route(means3d):
        out = _project_on_card(*args)
        project_gaussians.launches += 1
        return out
    return project_gaussians_plain(*args)


project_gaussians.launches = 0
project_gaussians.backward_launches = 0


def _on_card(means3d) -> bool:
    """Whether the Gaussians are on the card (the CPU tests stand it in)."""
    return means3d.is_cuda


def _needs_grad(xs) -> bool:
    """Whether any of ``xs`` is a tensor that needs grad."""
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _card_route(means3d) -> bool:
    """Whether a kernel may take the call: the Gaussians on the card and no
    torch.compile or torch.export trace running (Inductor fuses the plain
    version there, and a fake tensor has no memory)."""
    return not torch.compiler.is_compiling() and _on_card(means3d)


def _kernel_takes(means3d, others) -> bool:
    """Whether a kernel with no backward takes the call (K1's indexed
    variant): ``_card_route``, and nothing for autograd to record on
    ``means3d`` or ``others``."""
    return _card_route(means3d) and not (
        torch.is_grad_enabled() and _needs_grad((means3d,) + others))


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


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the arguments of csrc/project.cu's Camera, the same in both entries
_CAMERA_ARGTYPES = [_P, _I, _I] + [_P] * 4 + [_F] * 4 + [_I, _I, _P, _P, _F, _F] + [_F] * 5
# each entry's arguments after the camera and before (n, stream): the
# forward's five outputs; the backward's three cotangents (pointer and
# strides) and four gradients
_ENTRY_ARGTYPES = {
    "segsplat_project": [_P] * 5,
    "segsplat_project_bwd": [_P, _L, _L, _P, _L, _P, _L, _L] + [_P] * 4,
}


@functools.cache
def _project_fn(entry: str):
    """The C entry point ``entry`` of ``csrc/project.cu``: ``segsplat_project``
    or ``segsplat_project_bwd``, one library for both."""
    fn = getattr(cuda_build.load_library("project"), entry)
    fn.argtypes = [_P] * 4 + _CAMERA_ARGTYPES + _ENTRY_ARGTYPES[entry] + [_L, _P]
    fn.restype = ctypes.c_int
    return fn


def _call(entry: str, dev, args) -> None:
    with torch.cuda.device(dev):
        err = _project_fn(entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def _launch(dev, *args) -> None:
    """``segsplat_project(*args)`` on ``dev``'s current stream."""
    _call("segsplat_project", dev, args)


def _launch_backward(dev, *args) -> None:
    """``segsplat_project_bwd(*args)`` on ``dev``'s current stream."""
    _call("segsplat_project_bwd", dev, args)


def _camera_args(means3d, viewmat, fx, fy, cx, cy, width, height, znear, eps2d, tan_fovx,
                 tan_fovy, row0):
    """The kernels' camera arguments (csrc/project.cu's ``Camera``), checked,
    and the tensors on the card they point into."""
    dev = means3d.device
    _card_tensor(viewmat, "viewmat", dev, (4, 4))
    intr = [_card_scalar(x, name, dev) for x, name in ((fx, "fx"), (fy, "fy"),
                                                       (cx, "cx"), (cy, "cy"))]
    lx = _frustum_lim(tan_fovx, fx, 0.5 * width, dev)
    ly = _frustum_lim(tan_fovy, fy, 0.5 * height, dev)
    cam = (viewmat.data_ptr(), viewmat.stride(0), viewmat.stride(1),
           *(p for p, _ in intr), *(v for _, v in intr),
           lx[0], ly[0], lx[1], ly[1], lx[2], ly[2], float(znear), float(eps2d), row0,
           width, height)
    pointed = [viewmat] + [x for x in (fx, fy, cx, cy, tan_fovx, tan_fovy)
                           if isinstance(x, torch.Tensor) and x.is_cuda]
    return cam, pointed


def _project_on_card(means3d, scales, quats, viewmat, fx, fy, cx, cy, width, height,
                     znear, eps2d, tan_fovx, tan_fovy, row0) -> Projected:
    """Check the inputs and launch ``csrc/project.cu``: under autograd, as
    the forward of ``_ProjectFn``. The camera-space means (a cuBLAS product)
    and the quaternions' norms (a PyTorch reduction) run first, as the plain
    version runs them, and autograd records them: the kernel cannot reproduce
    their library's rounding, so it reads them."""
    n = means3d.shape[0] if means3d.dim() else 0
    for x, name, shape in ((means3d, "means3d", (n, 3)), (scales, "scales", (n, 3)),
                           (quats, "quats", (n, 4))):
        _card_tensor(x, name, means3d.device, shape)
    cam, pointed = _camera_args(means3d, viewmat, fx, fy, cx, cy, width, height, znear, eps2d,
                                tan_fovx, tan_fovy, row0)
    if torch.is_grad_enabled() and _needs_grad((viewmat, fx, fy, cx, cy, tan_fovx, tan_fovy)):
        raise ValueError("project_gaussians: the projection kernel reads the camera (viewmat, "
                         "fx, fy, cx, cy, tan_fovx, tan_fovy) as constants and gives it no "
                         "gradient; got a camera input that needs grad under grad mode")
    R_w2c = viewmat[:3, :3]
    t_cam = (means3d @ R_w2c.T + viewmat[:3, 3]).contiguous()
    qnorm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    inputs = (t_cam, qnorm, scales.contiguous(), quats.contiguous())
    if torch.is_grad_enabled() and _needs_grad(inputs):
        return Projected(*_ProjectFn.apply(*inputs, cam, *pointed))
    return _project_forward(*inputs, cam)


def _project_forward(t_cam, qnorm, scales, quats, cam) -> Projected:
    """One launch of ``segsplat_project`` on contiguous inputs."""
    dev, n = t_cam.device, t_cam.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    means2d, depths = torch.empty((n, 2), **f32), torch.empty((n,), **f32)
    conics, radii = torch.empty((n, 3), **f32), torch.empty((n,), **f32)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    _launch(dev, t_cam.data_ptr(), qnorm.data_ptr(), scales.data_ptr(), quats.data_ptr(),
            *cam, means2d.data_ptr(), depths.data_ptr(), conics.data_ptr(),
            radii.data_ptr(), valid.data_ptr(), n)
    return Projected(means2d, depths, conics, radii, valid)


def _cotangent(g, cols: int):
    """(pointer, row stride[, column stride]) of a cotangent for the backward
    kernel, which reads it in place; (None, 0[, 0]) where autograd gives none
    (it reads as zero)."""
    if g is None or g._is_zerotensor():
        return (None, 0, 0)[:2 + (cols > 1)]
    return (g.data_ptr(), g.stride(0)) + ((g.stride(1),) if cols > 1 else ())


class _ProjectFn(torch.autograd.Function):
    """``csrc/project.cu`` under autograd: the forward launches
    ``segsplat_project`` on (t_cam, the quaternions' norms, scales, quats) and
    keeps those four and the camera (its arguments and the tensors on the
    card they point into), no [N] intermediate; the backward launches
    ``segsplat_project_bwd``, which recomputes the forward's terms in
    registers and gives the four inputs' gradients from the cotangents of
    means2d, depths and conics. radii and valid carry no gradient."""

    @staticmethod
    def forward(ctx, t_cam, qnorm, scales, quats, cam, *pointed):
        out = _project_forward(t_cam, qnorm, scales, quats, cam)
        ctx.mark_non_differentiable(out.radii, out.valid)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(t_cam, qnorm, scales, quats, *pointed)
        ctx.cam = cam
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_means2d, g_depths, g_conics, _g_radii, _g_valid):
        t_cam, qnorm, scales, quats, *pointed = ctx.saved_tensors
        grads = [torch.empty_like(x) for x in (t_cam, qnorm, scales, quats)]
        _launch_backward(t_cam.device, t_cam.data_ptr(), qnorm.data_ptr(), scales.data_ptr(),
                         quats.data_ptr(), *ctx.cam, *_cotangent(g_means2d, 2),
                         *_cotangent(g_depths, 1), *_cotangent(g_conics, 3),
                         *(g.data_ptr() for g in grads), t_cam.shape[0])
        project_gaussians.backward_launches += 1
        return (*grads, None) + (None,) * len(pointed)


def _ewa_terms(t_cam, qnorm, scales, quats, R_w2c, fx, fy, znear, eps2d, lim_x, lim_y) -> dict:
    """The projection's terms by name, planar [N] tensors (3×3 lists of them
    for R, M, C) in eager operators, shared by the plain forward and the
    plain backward (``csrc/project.cu``'s ``ewa_terms`` names them alike). A
    dict, which torch.compile traces."""
    x, y, z = t_cam[:, 0], t_cam[:, 1], t_cam[:, 2]
    zc = torch.clamp_min(z, znear)
    rx, ry = x / zc, y / zc
    clx, cly = torch.clamp(rx, -lim_x, lim_x), torch.clamp(ry, -lim_y, lim_y)
    tx, ty = clx * zc, cly * zc

    qd = qnorm + 1e-12
    qn = quats / qd
    q = qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    R = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]]
    s = [scales[:, 0], scales[:, 1], scales[:, 2]]
    # M = R diag(s); Σ = M Mᵀ (symmetric, 6 unique components)
    M = [[R[r][j] * s[j] for j in range(3)] for r in range(3)]
    S = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(r, 3):
            S[r][c] = S[c][r] = M[r][0] * M[c][0] + M[r][1] * M[c][1] + M[r][2] * M[c][2]
    # P = W Σ as planar arrays, a row at a time, W = R_w2c; C = P Wᵀ (upper)
    W = R_w2c
    P = [[W[r, 0] * S[0][c] + W[r, 1] * S[1][c] + W[r, 2] * S[2][c] for c in range(3)]
         for r in range(3)]
    C = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(r, 3):
            C[r][c] = P[r][0] * W[c, 0] + P[r][1] * W[c, 1] + P[r][2] * W[c, 2]

    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx·x/z²], [0, fy/z, -fy·y/z²]
    t02, t12 = -fx * tx, -fy * ty
    j00, j02 = fx * inv_z, t02 * inv_z2
    j11, j12 = fy * inv_z, t12 * inv_z2
    A1 = j00 * C[0][0] + j02 * C[0][2]
    A2 = j00 * C[0][2] + j02 * C[2][2]
    B1 = j11 * C[0][1] + j12 * C[0][2]
    B2 = j11 * C[1][2] + j12 * C[2][2]
    D1 = j11 * C[1][1] + j12 * C[1][2]
    D2 = j11 * C[1][2] + j12 * C[2][2]
    a = j00 * A1 + j02 * A2 + eps2d
    b = j00 * B1 + j02 * B2
    c = j11 * D1 + j12 * D2 + eps2d

    det = a * c - b * b
    keep = det > 1e-12
    det = torch.where(keep, det, 1.0)
    return dict(x=x, y=y, z=z, zc=zc, rx=rx, ry=ry, clx=clx, cly=cly, qd=qd[:, 0], q=q, R=R,
                s=s, M=M, C=C, inv_z=inv_z, inv_z2=inv_z2, t02=t02, t12=t12, j00=j00, j02=j02,
                j11=j11, j12=j12, A1=A1, A2=A2, B1=B1, B2=B2, D1=D1, D2=D2, a=a, b=b, c=c,
                keep=keep, det=det, inv_det=1.0 / det)


def _frustum_lims(fx, fy, width, height, tan_fovx, tan_fovy):
    if tan_fovx is None:
        tan_fovx = (0.5 * width) / fx
    if tan_fovy is None:
        tan_fovy = (0.5 * height) / fy
    return 1.3 * tan_fovx, 1.3 * tan_fovy


def project_gaussians_plain(means3d, scales, quats, viewmat, fx, fy, cx, cy,
                            width: int, height: int, znear: float = 0.2,
                            eps2d: float = 0.3, tan_fovx=None, tan_fovy=None,
                            row0: int = 0) -> Projected:
    """``project_gaussians`` in eager PyTorch operators, differentiable: every
    call on the CPU or in a compiled trace; the forward kernel's yardstick,
    bit for bit."""
    R_w2c = viewmat[:3, :3]
    t_cam = means3d @ R_w2c.T + viewmat[:3, 3]
    e = _ewa_terms(t_cam, torch.linalg.norm(quats, dim=-1, keepdim=True), scales, quats, R_w2c,
                   fx, fy, znear, eps2d, *_frustum_lims(fx, fy, width, height, tan_fovx,
                                                        tan_fovy))
    a, b, c, det, inv_det = e["a"], e["b"], e["c"], e["det"], e["inv_det"]
    valid = (e["z"] > znear) & e["keep"]
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    u = fx * e["x"] * e["inv_z"] + cx
    v = fy * e["y"] * e["inv_z"] + cy
    if row0:
        v = v - row0
    means2d = torch.stack([u, v], dim=1)

    on_screen = ((u + radius > 0) & (u - radius < width) &
                 (v + radius > 0) & (v - radius < height))
    valid = valid & on_screen
    radius = torch.where(valid, radius, 0.0)
    return Projected(means2d, e["z"], conic, radius, valid)


def project_gaussians_vjp_plain(cotangents, t_cam, qnorm, scales, quats, viewmat, fx, fy,
                                cx, cy, width: int, height: int, znear: float = 0.2,
                                eps2d: float = 0.3, tan_fovx=None, tan_fovy=None,
                                row0: int = 0):
    """The projection's vector-Jacobian product in eager PyTorch operators:
    from the cotangents (means2d [N, 2], depths [N], conics [N, 3]; None
    reads as zero) to the gradients of t_cam [N, 3] = means3d @ R_w2cᵀ + t,
    the quaternions' norms [N, 1], scales [N, 3] and quats [N, 4] (the
    quotient's numerator; autograd adds the norm's share). The backward
    kernel's yardstick, bit for bit, in its order; autograd's conventions:
    clamp_min and clamp pass the gradient where the input lies within their
    bounds, ends included; ``where(det > 1e-12, det, 1)`` passes none through
    the 1; ceil gives the radius none; rows that are not valid get their
    chain-rule gradient. No program path runs it: the CPU differentiates
    ``project_gaussians_plain`` by autograd."""
    W = viewmat[:3, :3]
    lim_x, lim_y = _frustum_lims(fx, fy, width, height, tan_fovx, tan_fovy)
    e = types.SimpleNamespace(**_ewa_terms(t_cam, qnorm, scales, quats, W, fx, fy, znear,
                                           eps2d, lim_x, lim_y))
    zero = torch.zeros_like(e.z)
    g_m, g_d, g_c = cotangents
    gu, gv = (zero, zero) if g_m is None else (g_m[:, 0], g_m[:, 1])
    gz = zero if g_d is None else g_d
    g = [zero] * 3 if g_c is None else [g_c[:, j] for j in range(3)]

    # conic = (c, -b, a) / det
    d_c = g[0] * e.inv_det
    d_b = -(g[1] * e.inv_det)
    d_a = g[2] * e.inv_det
    d_inv = g[0] * e.c + g[1] * -e.b + g[2] * e.a
    d_det = torch.where(e.keep, -(d_inv * (e.inv_det * e.inv_det)), 0.0)
    d_a = d_a + d_det * e.c
    d_c = d_c + d_det * e.a
    d_b = d_b - (2.0 * e.b) * d_det

    # a = j00 A1 + j02 A2 + eps, b = j00 B1 + j02 B2, c = j11 D1 + j12 D2 + eps
    C = e.C
    dA1, dA2 = d_a * e.j00, d_a * e.j02
    dB1, dB2 = d_b * e.j00, d_b * e.j02
    dD1, dD2 = d_c * e.j11, d_c * e.j12
    d_j00 = (d_a * e.A1 + d_b * e.B1) + (dA1 * C[0][0] + dA2 * C[0][2])
    d_j02 = (d_a * e.A2 + d_b * e.B2) + (dA1 * C[0][2] + dA2 * C[2][2])
    d_j11 = (d_c * e.D1 + (dB1 * C[0][1] + dB2 * C[1][2])) + (dD1 * C[1][1] + dD2 * C[1][2])
    d_j12 = (d_c * e.D2 + (dB1 * C[0][2] + dB2 * C[2][2])) + (dD1 * C[1][2] + dD2 * C[2][2])
    dC = [[None] * 3 for _ in range(3)]
    dC[0][0] = dA1 * e.j00
    dC[0][1] = dB1 * e.j11
    dC[0][2] = dA1 * e.j02 + dA2 * e.j00 + dB1 * e.j12
    dC[1][1] = dD1 * e.j11
    dC[1][2] = dB2 * e.j11 + dD1 * e.j12 + dD2 * e.j11
    dC[2][2] = dA2 * e.j02 + dB2 * e.j12 + dD2 * e.j12

    # j00 = fx/z, j02 = (-fx·tx)/z², j11 = fy/z, j12 = (-fy·ty)/z²; u = (fx·x)/z + cx
    ux, vy = fx * e.x, fy * e.y
    d_inv_z = d_j00 * fx + d_j11 * fy + gu * ux + gv * vy
    d_inv_z2 = d_j02 * e.t02 + d_j12 * e.t12
    d_inv_z = d_inv_z + (2.0 * e.inv_z) * d_inv_z2
    d_tx = (d_j02 * e.inv_z2) * -fx
    d_ty = (d_j12 * e.inv_z2) * -fy
    d_x = (gu * e.inv_z) * fx
    d_y = (gv * e.inv_z) * fy
    # inv_z = 1/zc; tx = clamp(x/zc, ±lim_x)·zc, ty likewise
    d_zc = -(d_inv_z * e.inv_z2)
    d_zc = d_zc + d_tx * e.clx
    d_zc = d_zc + d_ty * e.cly
    d_rx = torch.where((e.rx >= -lim_x) & (e.rx <= lim_x), d_tx * e.zc, 0.0)
    d_ry = torch.where((e.ry >= -lim_y) & (e.ry <= lim_y), d_ty * e.zc, 0.0)
    d_x = d_x + d_rx / e.zc
    d_y = d_y + d_ry / e.zc
    d_zc = d_zc - d_rx * (e.rx / e.zc)
    d_zc = d_zc - d_ry * (e.ry / e.zc)
    # zc = clamp_min(z, znear); depth = z
    d_z = torch.where(e.z >= znear, d_zc, 0.0) + gz
    d_t_cam = torch.stack([d_x, d_y, d_z], dim=1)

    # C = P Wᵀ (upper), P = W Σ: dP[r][j] = Σ over c ≥ r of dC[r][c]·W[c][j]
    dP = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for j in range(3):
            acc = dC[r][r] * W[r, j]
            for c in range(r + 1, 3):
                acc = acc + dC[r][c] * W[c, j]
            dP[r][j] = acc
    # dS = Wᵀ dP over Σ's nine places; each of its six entries fills two of
    # them (one on the diagonal), and Σ = M Mᵀ, so dM = (dS + dSᵀ) M
    dS = [[W[0, m] * dP[0][c] + W[1, m] * dP[1][c] + W[2, m] * dP[2][c] for c in range(3)]
          for m in range(3)]
    G = [[dS[r][c] + dS[c][r] for c in range(3)] for r in range(3)]
    # M = R diag(s)
    dR = [[None] * 3 for _ in range(3)]
    ds = [None] * 3
    for r in range(3):
        for j in range(3):
            dM = G[r][0] * e.M[0][j] + G[r][1] * e.M[1][j] + G[r][2] * e.M[2][j]
            dR[r][j] = dM * e.s[j]
            term = dM * e.R[r][j]
            ds[j] = term if r == 0 else ds[j] + term
    d_scales = torch.stack(ds, dim=1)

    # R of the normalised quaternion (w, x, y, z)
    qw, qx, qy, qz = e.q
    d = dR
    dq = [2.0 * (qz * (d[1][0] - d[0][1]) + qy * (d[0][2] - d[2][0]) + qx * (d[2][1] - d[1][2])),
          2.0 * (qy * (d[0][1] + d[1][0]) + qz * (d[0][2] + d[2][0]) + qw * (d[2][1] - d[1][2])
                 - (2.0 * qx) * (d[1][1] + d[2][2])),
          2.0 * (qx * (d[0][1] + d[1][0]) + qz * (d[1][2] + d[2][1]) + qw * (d[0][2] - d[2][0])
                 - (2.0 * qy) * (d[0][0] + d[2][2])),
          2.0 * (qx * (d[0][2] + d[2][0]) + qy * (d[1][2] + d[2][1]) + qw * (d[1][0] - d[0][1])
                 - (2.0 * qz) * (d[0][0] + d[1][1]))]
    # q = quat / (|quat| + 1e-12)
    dot = dq[0] * e.q[0]
    for j in range(1, 4):
        dot = dot + dq[j] * e.q[j]
    d_quats = torch.stack([x / e.qd for x in dq], dim=1)
    d_qnorm = -(dot / e.qd)
    return d_t_cam, d_qnorm[:, None], d_scales, d_quats


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


def _pair_counts(offsets: torch.Tensor, K: int):
    """The real pairs of the tile runs and those past the per-tile cap K, 0-dim
    tensors, also given as the counts ``pairs`` and ``pairs_past_k`` of the
    open span (no host sync)."""
    num_pairs = offsets[-1]
    tile_overflow = torch.clamp_min(offsets[1:] - offsets[:-1] - K, 0).sum()
    count("pairs", num_pairs)
    count("pairs_past_k", tile_overflow)
    return num_pairs, tile_overflow


def bin_pairs(proj: Projected, opacities, width: int, height: int,
              max_tiles_per_axis: int, max_per_tile: int,
              pair_cap: Optional[int] = None, opacity_cull: bool = False,
              tile_row0: int = 0) -> Binned:
    """Every backend's bin stage, in the span ``raster.bin``:
    ``bin_gaussian_ranks`` on detached values, the counts ``pairs`` and
    ``pairs_past_k`` (``_pair_counts``), then ``pair_cap``, which truncates
    the sorted pairs: sentinel pairs sort to the tail, so any cap ≥ the
    frame's real pair count is exact. On overflow the deepest runs of the
    highest tile ids are dropped (the offsets are clamped, so reads stay in
    bounds)."""
    with annotate("raster.bin"):
        order, rank_sorted, offsets, (tx_n, ty_n) = bin_gaussian_ranks(
            Projected(*(x.detach() for x in proj)), width, height, max_tiles_per_axis,
            opacities=opacities.detach() if opacity_cull else None, tile_row0=tile_row0)
        num_pairs, tile_overflow = _pair_counts(offsets, max_per_tile)
        if pair_cap is not None and pair_cap < rank_sorted.shape[0]:
            rank_sorted = rank_sorted[:pair_cap]
            offsets = torch.clamp_max(offsets, pair_cap)
    return Binned(order, rank_sorted, offsets, tx_n, ty_n, num_pairs, tile_overflow)


def _gather_payload(proj: Projected, colors, opacities, b: Binned, K: int) -> torch.Tensor:
    """K1's payload [L+K, W]: ``make_payload``'s rows gathered into per-tile
    runs through ``b.order[b.rank_sorted]``, with K zero rows past the end, in
    the span ``raster.gather``, which counts ``rows``, the rows gathered
    before the pad. The gather carries gradients."""
    with annotate("raster.gather"):
        count("rows", b.rank_sorted.shape[0])
        rows = make_payload(proj.means2d, proj.conics, opacities, colors)[b.order[b.rank_sorted]]
        return torch.nn.functional.pad(rows, (0, 0, 0, K))


def build_blend_inputs(proj: Projected, colors, opacities, width: int, height: int,
                       max_tiles_per_axis: int, max_per_tile: int,
                       pair_cap: Optional[int] = None,
                       opacity_cull: bool = False, tile_row0: int = 0) -> BlendInputs:
    """Bin (``bin_pairs``: the counts, ``pair_cap``), then gather the pairs'
    payload rows into K1's payload (``_gather_payload``). K3's layout is
    ``pack_payload(sorted_payload[:-K], K)``. ``tile_row0``: see
    ``bin_gaussian_ranks``."""
    K = max_per_tile
    b = bin_pairs(proj, opacities, width, height, max_tiles_per_axis, K, pair_cap=pair_cap,
                  opacity_cull=opacity_cull, tile_row0=tile_row0)
    return BlendInputs(b.offsets, _gather_payload(proj, colors, opacities, b, K), b.tx_n,
                       b.ty_n, b.num_pairs, b.tile_overflow)


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

    The blend takes one of three routes, from the backend and what the call
    shows:

    - ``backend="dense"`` (the JAX package's ``"xla"``): ``_blend_tiles`` in
      torch ops, ``tile_chunk`` tiles at a time.
    - ``backend="cuda"`` (the JAX package's ``"pallas"``), where the Gaussians
      are on the card, no compile or export traces the call and nothing for
      autograd to record reaches the blend (colours, opacities, bg, the
      projected geometry): K1's indexed variant reads the rows through the
      pairs' depth ranks (``blend_tiles_indexed``, the same bits, no gathered
      payload).
    - ``backend="cuda"`` everywhere else: the gathered rows (``_gather_payload``)
      through K1's op ``blend``, K2 its backward; their plain versions on CPU
      tensors.

    Every route bins once (``bin_pairs``); ``pair_cap`` (see ``bin_pairs``)
    applies to the ``"cuda"`` routes only.

    The stages run in spans (``utils/profiling.annotate``): ``raster.project``
    (with the offset's add), ``raster.bin`` (counting ``pairs`` and
    ``pairs_past_k``), ``raster.gather`` (the gathered route's payload rows,
    counting ``rows``; on the indexed route the N-row table, which counts
    nothing, since no pair's row is gathered; the dense blend gathers inside
    its chunks) and ``raster.blend`` (the blend's op dispatch and launch on
    the card).

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
    b = bin_pairs(proj, opacities, width, height, max_tiles_per_axis, K,
                  pair_cap=pair_cap if backend == "cuda" else None,
                  opacity_cull=opacity_cull, tile_row0=tile_row0)
    if backend == "dense":
        with annotate("raster.blend"):
            img, alpha = _blend_tiles(b.order[b.rank_sorted], b.offsets, proj, colors,
                                      opacities, bg, b.tx_n, b.ty_n, K, tile_chunk)
    elif _kernel_takes(means3d, (proj.means2d, proj.conics, opacities, colors, bg)):
        # K1 reads each pair's row through its depth rank from the payload
        # table in depth order: no N·m²-row gather, no ids, no K zero rows
        with annotate("raster.gather"):
            table = make_payload(proj.means2d, proj.conics, opacities, colors)[b.order]
        with annotate("raster.blend"):
            img, alpha = blend_tiles_indexed(b.offsets, b.rank_sorted, table, bg,
                                             b.tx_n, b.ty_n, K)
    else:
        payload = _gather_payload(proj, colors, opacities, b, K)
        with annotate("raster.blend"):
            img, alpha = blend(b.offsets, payload, bg, b.tx_n, b.ty_n, K)
    return {
        "image": img[:height, :width],
        "alpha": alpha[:height, :width],
        "radii": proj.radii,
        "visible": proj.valid,
        "depths": proj.depths,
        "num_pairs": b.num_pairs,
        "tile_overflow": b.tile_overflow,
    }


def pad_logits_to_channels(logits: torch.Tensor, num_channels: int = 32) -> torch.Tensor:
    """Pad or slice per-Gaussian logits to the fixed raster channel count (the
    reference's NUM_CHANNELS=32 contract)."""
    n, c = logits.shape
    if c < num_channels:
        return torch.nn.functional.pad(logits, (0, num_channels - c))
    return logits[:, :num_channels]
