"""The projection kernels (segsplat_tpu_torch/csrc/project.cu) against their
plain versions on the card, bit for bit. The forward against
``project_gaussians_plain``: the five outputs equal (``torch.equal``) on the
view's scene at 1920×1080 over eight yaws, a strip of that frame, Gaussians
behind the near plane, degenerate covariances, Gaussians off-screen, Python-number
intrinsics and intrinsics off the card (0-dim CPU tensors, NumPy numbers),
outside autograd and under it. The backward ``segsplat_project_bwd`` against
``project_gaussians_vjp_plain`` on the same cases, with strided and missing
cotangents; the gradients of means3d, scales and quats through the
projection's autograd Function against autograd of the plain version, within
1e-5 of each leaf's largest; three train steps (``make_train_step``) on a
small scene with the kernels and with the plain projection. Inputs the kernel
cannot read raise on the card rather than take the plain version; the launch
counts: one forward a call, one backward a call autograd records, none where
the camera needs grad. Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_project_cuda.py

(tests/conftest.py imports JAX, which that machine does not have.) Without a
card every case skips."""

import copy
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
    kind = CASES[case][0]
    for yaw in YAWS if case == "view_yaws" else YAWS[1:3]:
        (xyz, scales, quats), other, kw = _case_inputs(case, yaw)
        ref = _assert_bit_equal((xyz, scales, quats, *other), kw)
        near = ref.depths > 0.2
        on = ref.valid
        assert int(on.sum()) > 0, "some Gaussians must be kept"
        if kind == "behind":
            assert int((~near).sum()) > N // 4
        if kind == "degenerate":   # in front and on screen, dropped by det ≤ 1e-12
            assert int((near & ~on).sum()) > 0
        if kind == "offscreen":
            assert int((near & ~on).sum()) > N // 2


def _case_inputs(case: str, yaw: float):
    """(xyz, scales, quats), the call's other arguments and keywords of a
    ``CASES`` entry at ``yaw``."""
    kind, intr_kind, strip = CASES[case]
    xyz, scales, quats = _scene(kind, seed=len(case))
    vm, intr = _camera(yaw)
    if intr_kind == "numbers":
        intr = tuple(float(x) for x in intr)
    elif intr_kind == "host":
        intr = _host_intrinsics(intr)
    kw, height = {}, H
    if strip:   # rows 256-511 of the frame: the frame's cy and tan-FoV, as parallel/render
        kw = dict(tan_fovx=(0.5 * W) / intr[0], tan_fovy=(0.5 * H) / intr[1], row0=STRIP_ROW0)
        if intr_kind == "host":   # numbers: torch.clamp takes no CPU bounds for card data
            kw.update(tan_fovx=float(kw["tan_fovx"]), tan_fovy=float(kw["tan_fovy"]))
        height = STRIP_H
    return (xyz, scales, quats), (vm, *intr, W, height), kw


def _cotangents(n: int, seed: int):
    g = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(shape, device="cuda", generator=g)
                 for shape in ((n, 2), (n,), (n, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_is_bit_equal_to_plain_version_on_card(case):
    """``segsplat_project_bwd`` through the autograd Function, taken at its
    own inputs (t_cam, the norms, scales, quats), against
    ``project_gaussians_vjp_plain``: all four gradients equal. Cotangents all
    given, depths' missing (the train step's), and strided (a column of a
    wider tensor, a broadcast one)."""
    _need_card()
    for yaw in YAWS[1:3]:
        (xyz, scales, quats), cam_args, kw = _case_inputs(case, yaw)
        vm = cam_args[0]
        n = xyz.shape[0]
        t_cam = (xyz @ vm[:3, :3].T + vm[:3, 3]).contiguous()
        qnorm = torch.linalg.norm(quats, dim=-1, keepdim=True)
        cam, pointed = R._camera_args(xyz, *cam_args, 0.2, 0.3, kw.get("tan_fovx"),
                                      kw.get("tan_fovy"), kw.get("row0", 0))
        g_m, g_d, g_c = _cotangents(n, len(case))
        wide = torch.cat([g_c, g_m], dim=1)            # [N, 5]: strided columns
        for cots in ((g_m, g_d, g_c), (g_m, None, g_c),
                     (wide[:, 3:], None, wide[:, :3]), (g_m[:1].expand(n, 2), g_d, None)):
            inputs = [x.detach().clone().requires_grad_(True)
                      for x in (t_cam, qnorm, scales, quats)]
            before = R.project_gaussians.backward_launches
            outs = R._ProjectFn.apply(*inputs, cam, *pointed)
            given = [(o, c) for o, c in zip(outs[:3], cots) if c is not None]
            got = torch.autograd.grad([o for o, _ in given], inputs, [c for _, c in given])
            ref = R.project_gaussians_vjp_plain(cots, t_cam, qnorm, scales, quats, *cam_args, **kw)
            torch.cuda.synchronize()
            assert R.project_gaussians.backward_launches == before + 1
            for name, g, r in zip(("t_cam", "qnorm", "scales", "quats"), got, ref):
                assert g.shape == r.shape, name
                assert torch.equal(g, r), f"{name}: {int((g != r).sum())} of {g.numel()} differ"


def _leaf_grads(fn, leaves, other, kw, cots):
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    out = fn(*leaves, *other, **kw)
    grads = torch.autograd.grad((out.means2d, out.conics), leaves, (cots[0], cots[2]))
    return out, grads


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_through_the_function_agree_with_autograd_on_card(case):
    """``project_gaussians`` under autograd on the card (the Function) against
    autograd of ``project_gaussians_plain``: the forward's five outputs
    equal, one forward and one backward launch, and the gradients of means3d,
    scales and quats within 1e-5 of each leaf's largest (float32, two orders
    of the same sums)."""
    _need_card()
    leaves, other, kw = _case_inputs(case, YAWS[1])
    cots = _cotangents(leaves[0].shape[0], 7)
    before = R.project_gaussians.launches, R.project_gaussians.backward_launches
    got_out, got = _leaf_grads(R.project_gaussians, leaves, other, kw, cots)
    torch.cuda.synchronize()
    assert (R.project_gaussians.launches, R.project_gaussians.backward_launches) == (
        before[0] + 1, before[1] + 1)
    ref_out, ref = _leaf_grads(R.project_gaussians_plain, leaves, other, kw, cots)
    assert got_out.means2d.requires_grad and not got_out.radii.requires_grad
    for name in R.Projected._fields:
        assert torch.equal(getattr(got_out, name).detach(), getattr(ref_out, name).detach()), name
    for name, g, r in zip(("means3d", "scales", "quats"), got, ref):
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert bool(torch.isfinite(g).all()), name
        assert err <= 1e-5 * scale, f"{name}: {err:.3e} > 1e-5 · {scale:.3e}"


@pytest.mark.cuda
def test_launch_count_follows_autograd_on_card():
    """One forward launch a call; a call autograd records (means3d needs
    grad) launches the backward once on ``.backward()``; under
    ``torch.no_grad()`` no backward; a camera that needs grad raises
    ValueError under grad mode and launches nothing, and under
    ``torch.no_grad()`` launches the forward."""
    _need_card()
    xyz, scales, quats = _scene("box")
    vm, intr = _camera(0.05)
    before = R.project_gaussians.launches, R.project_gaussians.backward_launches
    counts = lambda: (R.project_gaussians.launches - before[0],
                      R.project_gaussians.backward_launches - before[1])
    with torch.no_grad():
        R.project_gaussians(xyz, scales, quats, vm, *intr, W, H)
        R.project_gaussians(xyz.requires_grad_(True), scales, quats, vm, *intr, W, H)
    assert counts() == (2, 0)
    out = R.project_gaussians(xyz, scales, quats, vm, *intr, W, H)
    assert counts() == (3, 0)
    assert out.means2d.requires_grad
    out.means2d.sum().backward()
    assert counts() == (3, 1)
    assert xyz.grad is not None and bool(torch.isfinite(xyz.grad).all())
    xyz.grad = None
    vm = vm.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="projection kernel reads the camera"):
        R.project_gaussians(xyz, scales, quats, vm, *intr, W, H)
    assert counts() == (3, 1)
    with torch.no_grad():
        R.project_gaussians(xyz, scales, quats, vm, *intr, W, H)
    assert counts() == (4, 1)


def _train_scene(seed: int = 0):
    """A small training state on the card: 3 000 points before the camera,
    anisotropic scales and random rotations (the rotation's gradient is 0
    at the initial isotropic scales), a 160×120 view and its GT."""
    from segsplat_tpu_torch.train import trainer as T

    rng = np.random.default_rng(seed)
    n, cap = 3000, 4096
    pts = (rng.random((n, 3)) * np.array([3.0, 2.0, 2.0]) + np.array([-1.5, -1.0, 2.0]))
    table = T.init_table_from_pcd(pts.astype(np.float32), rng.random((n, 3)).astype(np.float32),
                                  cap, seed=seed, device="cuda")
    with torch.no_grad():
        table.scaling.add_(torch.as_tensor(rng.normal(0, 0.5, (cap, 3)), dtype=torch.float32,
                                           device="cuda"))
        table.rotation.copy_(torch.as_tensor(rng.normal(size=(cap, 4)), dtype=torch.float32,
                                             device="cuda"))
    state = T.init_state(table, T.OptimizationConfig(num_classes=16), spatial_lr_scale=2.0)
    w, h = 160, 120
    f32 = dict(dtype=torch.float32, device="cuda")
    cam = Camera(R=torch.eye(3, **f32), T=torch.tensor([0.05, -0.02, 0.1], **f32),
                 fov_x=torch.tensor(1.2, **f32), fov_y=torch.tensor(0.95, **f32),
                 width=w, height=h)
    gt = torch.as_tensor(rng.random((3, h, w)), **f32)
    gto = torch.as_tensor((np.arange(h)[:, None] // 30) * 4 + np.arange(w)[None, :] // 40,
                          dtype=torch.int32, device="cuda")
    return state, cam, gt, gto


@pytest.mark.cuda
def test_train_steps_with_the_kernels_match_the_plain_projection(monkeypatch):
    """Three ``make_train_step`` steps with the projection's kernels (one
    forward and one backward launch a step). Before each, a copy of the state
    takes the same step with the plain projection (``_project_on_card``
    standing in for it): the loss terms are bit-equal (the forward's bits are
    the plain version's), and the gradients of xyz, scaling and rotation lie
    within 1e-5 of each leaf's largest."""
    _need_card()
    from segsplat_tpu_torch.train import trainer as T

    state, cam, gt, gto = _train_scene()
    step = T.make_train_step(T.OptimizationConfig(num_classes=16),
                             dict(max_tiles_per_axis=4, max_per_tile=128, backend="cuda"))
    g = torch.Generator("cuda")
    idx = lambda i: torch.randint(0, cam.width * cam.height, (4096,), device="cuda",
                                  generator=g.manual_seed(i))
    kernel_route = R._project_on_card
    leaves = ("xyz", "scaling", "rotation")
    for i in range(3):
        plain_state = copy.deepcopy(state)
        monkeypatch.setattr(R, "_project_on_card", lambda *a: R.project_gaussians_plain(*a))
        ref = step(plain_state, cam, gt, gto, torch.zeros(3, device="cuda"), idx=idx(i))
        monkeypatch.setattr(R, "_project_on_card", kernel_route)
        before = R.project_gaussians.launches, R.project_gaussians.backward_launches
        got = step(state, cam, gt, gto, torch.zeros(3, device="cuda"), idx=idx(i))
        torch.cuda.synchronize()
        assert (R.project_gaussians.launches - before[0],
                R.project_gaussians.backward_launches - before[1]) == (1, 1)
        for k in got:
            assert torch.equal(got[k], ref[k]), (i, k, float(got[k]), float(ref[k]))
        for k in leaves:
            a, b = getattr(state.table, k).grad, getattr(plain_state.table, k).grad
            scale = float(b.abs().max())
            assert scale > 0, k
            assert float((a - b).abs().max()) <= 1e-5 * scale, (i, k)


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
