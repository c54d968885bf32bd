"""The projection kernel (segsplat_tpu_torch/csrc/project.cu) against the plain
version ``project_gaussians_plain`` on the card, bit for bit: the five outputs
equal (``torch.equal``) on the view's scene at 1920×1080 over eight yaws, a
strip of that frame, Gaussians behind the near plane, degenerate covariances,
Gaussians off-screen, Python-number intrinsics and intrinsics off the card
(0-dim CPU tensors, NumPy numbers); inputs the kernel cannot read raise on the
card rather than take the plain version; and the launch count, one a call
outside autograd and none where an input needs grad. Imports no JAX, so
it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_project_cuda.py

(tests/conftest.py imports JAX, which that machine does not have.) Without a
card every case skips."""

import math

import numpy as np
import pytest
import torch

from segsplat_tpu_torch.core.types import Camera
from segsplat_tpu_torch.ops import rasterize as R

N = 200_000
W, H = 1920, 1080
YAWS = [0.15 * math.sin(2 * math.pi * k / 8) for k in range(8)]
STRIP_ROW0, STRIP_H = 256, 256


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _scene(kind: str, seed: int = 0):
    """xyz, scales, quats (normalised as ``GaussianTable.get_rotation`` does,
    but for ``raw_quats``) of the view cell's draw: means in the box [-2, 2] ×
    [-1.5, 1.5] × [2, 6] m, log N(-4.6, 0.3) scales, normal quaternions; and
    variants of it."""
    g = torch.Generator("cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    xyz = (torch.rand((N, 3), **kw) * torch.tensor([4.0, 3.0, 4.0], device="cuda")
           + torch.tensor([-2.0, -1.5, 2.0], device="cuda"))
    log_s = torch.randn((N, 3), **kw) * 0.3 - 4.6
    q = torch.randn((N, 4), **kw)
    if kind == "behind":           # z in [-1, 0.5]: about half behind znear = 0.2
        xyz[:, 2] = torch.rand(N, **kw) * 1.5 - 1.0
    elif kind == "offscreen":      # |x| in [4, 24] m: past the frustum clamp, most off-screen
        xyz[:, 0] = (torch.rand(N, **kw) * 20 + 4) * torch.sign(torch.randn(N, **kw))
    elif kind == "degenerate":     # needles: a ~e^2-e^8 m axis, the others e^-12
        log_s[:, 0] = torch.rand(N, **kw) * 6 + 2
        log_s[:, 1:] = -12.0
    elif kind == "raw_quats":      # norms up to 5, normalised only inside the projection
        q = q * torch.rand((N, 1), **kw) * 5
    if kind != "raw_quats":
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    return xyz, torch.exp(log_s), q


def _camera(yaw: float):
    """The view cell's camera (fov 1.2 × 0.75 rad, turned about y): its
    world-to-view matrix and fx, fy, cx, cy as 0-dim tensors on the card."""
    c, s = math.cos(yaw), math.sin(yaw)
    rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    cam = Camera(R=rot, T=torch.zeros(3, **f32), fov_x=torch.tensor(1.2, **f32),
                 fov_y=torch.tensor(0.75, **f32), width=W, height=H)
    K = cam.intrinsics()
    return cam.world_view_transform(), (K[0, 0], K[1, 1], K[0, 2], K[1, 2])


def _assert_bit_equal(args, kw):
    before = R.project_gaussians.launches
    with torch.no_grad():
        got = R.project_gaussians(*args, **kw)
    ref = R.project_gaussians_plain(*args, **kw)
    torch.cuda.synchronize()
    assert R.project_gaussians.launches == before + 1
    for name in R.Projected._fields:
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert g.is_contiguous(), name
        assert torch.equal(g, r), f"{name}: {int((g != r).sum())} of {g.numel()} differ"
    return ref


def _host_intrinsics(intr):
    """fx, fy as 0-dim CPU tensors, cx as a NumPy float32, cy as a Python
    number: each read on the host, with no wait on the card."""
    fx, fy, cx, cy = (x.cpu() for x in intr)
    return fx, fy, np.float32(cx.item()), float(cy)


# name: (scene, intrinsics: on the card, Python numbers or off the card, strip)
CASES = {
    "view_yaws": ("box", "card", False),
    "strip": ("box", "card", True),
    "behind_near_plane": ("behind", "card", False),
    "degenerate_covariances": ("degenerate", "card", False),
    "off_screen": ("offscreen", "card", False),
    "unnormalised_quats": ("raw_quats", "card", False),
    "python_intrinsics": ("box", "numbers", False),
    "python_intrinsics_strip": ("box", "numbers", True),
    "host_intrinsics_strip": ("box", "host", True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_is_bit_equal_to_plain_version_on_card(case):
    _need_card()
    kind, intr_kind, strip = CASES[case]
    xyz, scales, quats = _scene(kind, seed=len(case))
    for yaw in YAWS if case == "view_yaws" else YAWS[1:3]:
        vm, intr = _camera(yaw)
        if intr_kind == "numbers":
            intr = tuple(float(x) for x in intr)
        elif intr_kind == "host":
            intr = _host_intrinsics(intr)
        kw = {}
        height = H
        if strip:   # rows 256-511 of the frame: the frame's cy and tan-FoV, as parallel/render
            kw = dict(tan_fovx=(0.5 * W) / intr[0], tan_fovy=(0.5 * H) / intr[1],
                      row0=STRIP_ROW0)
            if intr_kind == "host":   # numbers: torch.clamp takes no CPU bounds for card data
                kw.update(tan_fovx=float(kw["tan_fovx"]), tan_fovy=float(kw["tan_fovy"]))
            height = STRIP_H
        ref = _assert_bit_equal((xyz, scales, quats, vm, *intr, W, height), kw)
        near = ref.depths > 0.2
        on = ref.valid
        assert int(on.sum()) > 0, "some Gaussians must be kept"
        if kind == "behind":
            assert int((~near).sum()) > N // 4
        if kind == "degenerate":   # in front and on screen, dropped by det ≤ 1e-12
            assert int((near & ~on).sum()) > 0
        if kind == "offscreen":
            assert int((near & ~on).sum()) > N // 2


@pytest.mark.cuda
def test_launch_count_follows_autograd_on_card():
    """One launch a call under ``torch.no_grad()``; none where means3d needs
    grad, and that call's means2d carries a gradient."""
    _need_card()
    xyz, scales, quats = _scene("box")
    vm, intr = _camera(0.05)
    before = R.project_gaussians.launches
    with torch.no_grad():
        R.project_gaussians(xyz, scales, quats, vm, *intr, W, H)
        R.project_gaussians(xyz.requires_grad_(True), scales, quats, vm, *intr, W, H)
    assert R.project_gaussians.launches == before + 2
    out = R.project_gaussians(xyz, scales, quats, vm, *intr, W, H)
    assert R.project_gaussians.launches == before + 2
    assert out.means2d.requires_grad
    out.means2d.sum().backward()
    assert xyz.grad is not None and bool(torch.isfinite(xyz.grad).all())


# name: what is wrong with the call's inputs on the card
UNREADABLE = {
    "float64_scales": lambda a: a.__setitem__(1, a[1].double()),
    "viewmat_on_cpu": lambda a: a.__setitem__(3, a[3].cpu()),
    "focal_of_shape_1": lambda a: a.__setitem__(4, a[4].reshape(1)),
    "float64_focal": lambda a: a.__setitem__(4, a[4].double()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(UNREADABLE))
def test_unreadable_inputs_raise_on_card(case):
    """On the card, outside autograd, an input the kernel cannot read raises
    ValueError and launches nothing: no call on the card takes the plain
    version but for autograd or a compile trace."""
    _need_card()
    xyz, scales, quats = _scene("box")
    vm, intr = _camera(0.05)
    args = [xyz, scales, quats, vm, *intr, W, H]
    UNREADABLE[case](args)
    before = R.project_gaussians.launches
    with torch.no_grad(), pytest.raises(ValueError, match="projection kernel reads"):
        R.project_gaussians(*args)
    assert R.project_gaussians.launches == before
