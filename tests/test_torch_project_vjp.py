"""The projection's plain backward ``project_gaussians_vjp_plain``
(segsplat_tpu_torch/ops/rasterize.py), the yardstick of the backward kernel in
csrc/project.cu, held against autograd of ``project_gaussians_plain`` on the
CPU: on the shared 64×48 scenes of 500 Gaussians and on the edges of the
projection (behind the near plane, on it, past and at the frustum clamp, a
degenerate 2D covariance, unnormalised quaternions, off-screen, a strip, tensor
and Python intrinsics). In float64 the two agree to 1e-10 of each leaf's
largest gradient; in float32 to 1e-5 of it. The kernel itself is held to the
plain backward bit for bit on the card (tests/test_torch_project_cuda.py)."""

import numpy as np
import pytest
import torch

from segsplat_tpu_torch.ops import rasterize as Pr
from _torch_port import F, H, W, scene, viewmat

ZNEAR = 0.2
LIM_X = 1.3 * (0.5 * W / F)   # the frustum clamp of x/z with the default tan-FoV


def _edge_scene(case: str) -> dict:
    """The scene of ``case``, float64 numpy arrays: scene(0) changed at its
    first rows (each change keeps the other rows as drawn)."""
    sc = {k: v.astype(np.float64) for k, v in scene(0).items()}
    xyz, s, q = sc["xyz"], sc["scales"], sc["quats"]
    rng = np.random.default_rng(11)
    if case == "behind_near_plane":          # z in [-1, 0.5]: many behind znear
        xyz[:200, 2] = np.linspace(-1.0, 0.5, 200)
    elif case == "on_near_plane":            # z == znear exactly, x and y small
        xyz[:50, 2] = ZNEAR
        xyz[:50, :2] *= 0.05
    elif case == "past_frustum_clamp":       # |x/z|, |y/z| up to 4·1.3·tan-FoV
        xyz[:200, 0] = xyz[:200, 2] * LIM_X * rng.uniform(1.0, 4.0, 200) * rng.choice([-1, 1], 200)
        xyz[200:400, 1] = xyz[200:400, 2] * LIM_X * rng.uniform(1.0, 4.0, 200)
    elif case == "at_frustum_clamp":         # x/z == ±1.3·tan-FoV exactly (z = 1)
        xyz[:40, 2] = 1.0
        xyz[:40, 0] = LIM_X * np.where(np.arange(40) % 2, 1.0, -1.0)
    elif case == "degenerate_det":           # zero scales at no low-pass: det = 0
        s[:60] = 0.0
    elif case == "unnormalised_quats":
        q *= rng.uniform(0.1, 5.0, (len(q), 1))
    elif case == "off_screen":
        xyz[:, 0] *= 10.0
    return sc


# name: (scene: a seed of the shared scenes or an edge case, view, intrinsics:
# "numbers" or 0-dim "tensors", keyword arguments of the projection)
CASES = {
    "scene0_identity": (0, "identity", "numbers", {}),
    "scene0_rotated": (0, "rotated", "numbers", {}),
    "scene1_rotated": (1, "rotated", "numbers", {}),
    "scene2_rotated_tensor_intrinsics": (2, "rotated", "tensors", {}),
    "behind_near_plane": ("behind_near_plane", "rotated", "numbers", {}),
    "on_near_plane": ("on_near_plane", "identity", "numbers", {}),
    "past_frustum_clamp": ("past_frustum_clamp", "rotated", "numbers", {}),
    "at_frustum_clamp": ("at_frustum_clamp", "identity", "numbers", {}),
    "degenerate_det": ("degenerate_det", "rotated", "numbers", dict(eps2d=0.0)),
    "unnormalised_quats": ("unnormalised_quats", "rotated", "tensors", {}),
    "off_screen": ("off_screen", "rotated", "numbers", {}),
    "strip_row0": (3, "rotated", "tensors",
                   dict(tan_fovx=0.5 * W / F, tan_fovy=0.5 * H / F, row0=16)),
}


def _inputs(case: str, dtype):
    kind, view, intr_kind, kw = CASES[case]
    sc = ({k: v.astype(np.float64) for k, v in scene(kind).items()} if isinstance(kind, int)
          else _edge_scene(kind))
    leaves = [torch.tensor(sc[k], dtype=dtype, requires_grad=True)
              for k in ("xyz", "scales", "quats")]
    vm = torch.tensor(viewmat(view), dtype=dtype)
    intr = (F, F, W / 2, H / 2)
    if intr_kind == "tensors":
        intr = tuple(torch.tensor(x, dtype=dtype) for x in intr)
    height = 16 if "row0" in kw else H
    return leaves, (vm, *intr, W, height), kw


def _cotangents(n: int, dtype, seed: int):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, dtype=dtype) for shape in ((n, 2), (n,), (n, 3)))


def _both(case: str, dtype, cot_mask=(True, True, True)):
    """Each leaf's gradient by autograd of the plain projection, and by the
    plain backward chained through the eager matmul and norm (as the card's
    Function chains its kernel)."""
    leaves, cam, kw = _inputs(case, dtype)
    out = Pr.project_gaussians_plain(*leaves, *cam, **kw)
    cots = [c if m else None
            for c, m in zip(_cotangents(leaves[0].shape[0], dtype, len(case)), cot_mask)]
    pairs = [(o, c) for o, c in zip((out.means2d, out.depths, out.conics), cots) if c is not None]
    ref = torch.autograd.grad([o for o, _ in pairs], leaves, [c for _, c in pairs],
                              allow_unused=True, materialize_grads=True)
    vm = cam[0]
    t_cam = leaves[0] @ vm[:3, :3].T + vm[:3, 3]
    qnorm = torch.linalg.norm(leaves[2], dim=-1, keepdim=True)
    grads = Pr.project_gaussians_vjp_plain(cots, t_cam.detach(), qnorm.detach(),
                                           leaves[1].detach(), leaves[2].detach(), *cam, **kw)
    got = torch.autograd.grad((t_cam, qnorm, leaves[1], leaves[2]), leaves, grads)
    return out, got, ref


def _assert_within(got, ref, share: float):
    """Each leaf within ``share`` of its largest reference gradient (exact
    where that is 0: means2d alone reaches no scale or rotation)."""
    for name, g, r in zip(("means3d", "scales", "quats"), got, ref):
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert err <= share * scale, f"{name}: {err:.3e} > {share:g} · {scale:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_plain_equals_autograd_float64(case):
    out, got, ref = _both(case, torch.float64)
    _assert_within(got, ref, 1e-10)
    z, valid = out.depths.detach(), out.valid
    if case == "behind_near_plane":
        assert int((z <= ZNEAR).sum()) > 50
    if case == "on_near_plane":
        assert int((z == ZNEAR).sum()) == 50
    if case == "degenerate_det":    # in front, dropped by det ≤ 1e-12
        assert int(((z > ZNEAR) & ~valid).sum()) >= 50
    if case == "off_screen":
        assert int(((z > ZNEAR) & ~valid).sum()) > 250
    assert int(valid.sum()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_plain_within_float32_rounding_of_autograd(case):
    _, got, ref = _both(case, torch.float32)
    _assert_within(got, ref, 1e-5)


@pytest.mark.parametrize("given", ["means2d", "conics", "means2d_conics"])
def test_vjp_plain_reads_a_missing_cotangent_as_zero(given):
    """The train step gives depths no cotangent; a missing one is zero."""
    mask = ("means2d" in given, False, "conics" in given)
    _, got, ref = _both("scene0_rotated", torch.float64, mask)
    _assert_within(got, ref, 1e-10)


def test_at_frustum_clamp_passes_the_gradient():
    """x/z exactly at ±1.3·tan-FoV passes its gradient to x (autograd's
    clamp: ends included), in float64 and float32 alike."""
    for dtype in (torch.float64, torch.float32):
        leaves, cam, kw = _inputs("at_frustum_clamp", dtype)
        out = Pr.project_gaussians_plain(*leaves, *cam, **kw)
        rx = leaves[0][:40, 0] / leaves[0][:40, 2]
        assert bool((rx.abs() == torch.tensor(LIM_X, dtype=dtype)).all())
        vm = cam[0]
        t_cam = (leaves[0] @ vm[:3, :3].T + vm[:3, 3]).detach()
        qnorm = torch.linalg.norm(leaves[2], dim=-1, keepdim=True).detach()
        conic_only = torch.zeros_like(out.conics)
        conic_only[:, 1] = 1.0             # b depends on x/z through j02
        d_t_cam = Pr.project_gaussians_vjp_plain(
            (None, None, conic_only), t_cam, qnorm, leaves[1].detach(), leaves[2].detach(),
            *cam)[0]
        assert bool((d_t_cam[:40, 0] != 0).all())
