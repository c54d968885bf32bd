"""The port's projection, binning and rasterize (segsplat_tpu_torch/ops/rasterize.py)
held against the JAX package on the CPU. The JAX side runs its Pallas path in
interpret mode, as tests/test_blend_pallas.py does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu.ops import rasterize as Rz
from segsplat_tpu.scene import table_from_arrays as jax_table_from_arrays
from segsplat_tpu_torch.convert import table_from_jax_arrays
from segsplat_tpu_torch.ops import rasterize as Pr
from _torch_port import F, H, SCENES, W, scene, viewmat

t = torch.from_numpy


def _project_both(sc, vm):
    args = (sc["xyz"], sc["scales"], sc["quats"])
    jproj = Rz.project_gaussians(*map(jnp.asarray, args), jnp.asarray(vm),
                                 F, F, W / 2, H / 2, W, H)
    tproj = Pr.project_gaussians(*map(t, args), t(vm), F, F, W / 2, H / 2, W, H)
    return jproj, tproj


@pytest.mark.parametrize("view", ["identity", "rotated"])
def test_project_gaussians_matches_jax(view):
    jproj, tproj = _project_both(scene(0), viewmat(view))
    assert np.asarray(jproj.valid).sum() > 100, "scene must be visible"
    for name in ("means2d", "depths", "conics", "radii"):
        np.testing.assert_allclose(getattr(tproj, name).numpy(),
                                   np.asarray(getattr(jproj, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tproj.valid.numpy(), np.asarray(jproj.valid))


@pytest.mark.parametrize("opacity_cull", [False, True])
def test_bin_gaussian_ranks_matches_jax(opacity_cull):
    """Exact, fed the same Projected from JAX so that rounding at a ceil(3σ)
    radius cannot move a pair."""
    sc = scene(1, n=1500, log_scale=-2.0, opac_range=(0.01, 0.9))
    jproj, _ = _project_both(sc, viewmat("rotated"))
    tproj = Pr.Projected(*(t(np.array(x)) for x in jproj))
    op = sc["opac"] if opacity_cull else None
    j_order, j_ranks, j_off, j_dims = Rz._bin_gaussian_ranks(
        jproj, W, H, 4, opacities=None if op is None else jnp.asarray(op))
    p_order, p_ranks, p_off, p_dims = Pr.bin_gaussian_ranks(
        tproj, W, H, 4, opacities=None if op is None else t(op))
    assert p_dims == j_dims
    np.testing.assert_array_equal(p_order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(p_ranks.numpy(), np.asarray(j_ranks))
    np.testing.assert_array_equal(p_off.numpy(), np.asarray(j_off))
    if opacity_cull:            # the cull must have removed pairs to be tested
        _, _, uncut, _ = Rz._bin_gaussian_ranks(jproj, W, H, 4)
        assert int(p_off[-1]) < int(np.asarray(uncut)[-1])


RASTER_CASES = {
    # name: (scene kind, view, K, pair_cap as a fraction of the real pairs, cull)
    "k128": ("light", "identity", 128, None, False),
    "k256_rotated": ("light", "rotated", 256, None, False),
    "k384_deep": ("deep", "identity", 384, None, False),
    "opaque_early_out": ("opaque", "identity", 384, None, False),
    "pair_cap_half": ("light", "identity", 128, 0.5, False),
    "opacity_cull": ("deep", "rotated", 128, None, True),
}


@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_rasterize_matches_jax(case):
    kind, view, K, cap_frac, cull = RASTER_CASES[case]
    seed, n, log_scale, opac_range = SCENES[kind]
    sc = scene(seed, n, log_scale, opac_range)
    vm = viewmat(view)
    names = ("xyz", "scales", "quats", "opac", "colors")
    kw = dict(width=W, height=H, max_tiles_per_axis=4, max_per_tile=K,
              opacity_cull=cull)
    pair_cap = None
    if cap_frac is not None:
        full = Pr.rasterize(*(t(sc[k]) for k in names), t(vm), F, F, W / 2, H / 2,
                            bg=t(sc["bg"]), **kw)
        pair_cap = int(int(full["num_pairs"]) * cap_frac)
    with pltpu.force_tpu_interpret_mode():
        ref = Rz.rasterize(*(jnp.asarray(sc[k]) for k in names), jnp.asarray(vm),
                           F, F, W / 2, H / 2, bg=jnp.asarray(sc["bg"]),
                           backend="pallas", pair_cap=pair_cap, **kw)
    got = Pr.rasterize(*(t(sc[k]) for k in names), t(vm), F, F, W / 2, H / 2,
                       bg=t(sc["bg"]), pair_cap=pair_cap, **kw)
    assert set(got) == set(ref)
    for name in ("image", "alpha"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("radii", "depths"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got["visible"].numpy(), np.asarray(ref["visible"]))
    assert int(got["num_pairs"]) == int(ref["num_pairs"])
    assert int(got["tile_overflow"]) == int(ref["tile_overflow"])
    if pair_cap is not None:
        assert pair_cap < int(got["num_pairs"])
    if kind == "deep":
        assert int(got["tile_overflow"]) > 0, "deep scene must exceed K somewhere"


def test_tile_depth_counts_matches_jax():
    sc = scene(3)
    vm = viewmat("rotated")
    args = (sc["xyz"], sc["scales"], sc["quats"])
    ref = Rz.tile_depth_counts(*map(jnp.asarray, args), jnp.asarray(vm),
                               F, F, W / 2, H / 2, W, H, max_tiles_per_axis=4)
    got = Pr.tile_depth_counts(*map(t, args), t(vm), F, F, W / 2, H / 2, W, H,
                               max_tiles_per_axis=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("channels", [3, 32, 40])
def test_pad_logits_to_channels_matches_jax(channels):
    x = np.random.default_rng(channels).standard_normal((7, channels)).astype(np.float32)
    np.testing.assert_array_equal(Pr.pad_logits_to_channels(t(x), 32).numpy(),
                                  np.asarray(Rz.pad_logits_to_channels(jnp.asarray(x), 32)))


def test_table_from_jax_arrays_round_trip():
    rng = np.random.default_rng(4)
    n = 37
    arrays = dict(xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
                  features_rest=rng.normal(size=(n, 15, 3)),
                  scaling=rng.normal(-3, 0.5, (n, 3)), rotation=rng.normal(size=(n, 4)),
                  opacity=rng.normal(size=(n, 1)), objects_dc=rng.normal(size=(n, 1, 16)))
    jt = jax_table_from_arrays({k: v.astype(np.float32) for k, v in arrays.items()},
                               capacity=64)
    fields = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)}
    pt = table_from_jax_arrays(fields, device="cpu")
    assert pt.capacity == jt.capacity and pt.max_sh_degree == jt.max_sh_degree
    assert pt.active_sh_degree == int(jt.active_sh_degree)
    np.testing.assert_array_equal(pt.active.numpy(), np.asarray(jt.active))
    for mine, ref in ((pt.get_scaling(), jt.get_scaling()),
                      (pt.get_rotation(), jt.get_rotation()),
                      (pt.get_opacity(), jt.get_opacity()),
                      (pt.get_features(), jt.get_features())):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError, match="active"):
        table_from_jax_arrays({k: v for k, v in fields.items() if k != "active"},
                              device="cpu")


def test_rasterize_tan_fov_matches_jax():
    """The frustum clamp's tan_fovx and tan_fovy given, as a strip of a
    taller frame passes them, against JAX ``rasterize`` with the same; left
    out, they are 0.5·width/fx and 0.5·height/fy, the same bits as given so."""
    sc = scene(0, n=1500, log_scale=-2.0)
    vm = viewmat("rotated")
    names = ("xyz", "scales", "quats", "opac", "colors")
    kw = dict(width=W, height=H, max_tiles_per_axis=4, max_per_tile=128)
    targs = [t(sc[k]) for k in names] + [t(vm), F, F, W / 2, H / 2]
    plain = Pr.rasterize(*targs, bg=t(sc["bg"]), **kw)
    given = Pr.rasterize(*targs, bg=t(sc["bg"]), tan_fovx=(0.5 * W) / F,
                         tan_fovy=(0.5 * H) / F, **kw)
    for name in ("image", "alpha", "radii"):
        assert torch.equal(given[name], plain[name]), name
    tight = dict(tan_fovx=0.2, tan_fovy=0.15)
    with pltpu.force_tpu_interpret_mode():
        ref = Rz.rasterize(*(jnp.asarray(sc[k]) for k in names), jnp.asarray(vm),
                           F, F, W / 2, H / 2, bg=jnp.asarray(sc["bg"]), backend="pallas",
                           **tight, **kw)
    got = Pr.rasterize(*targs, bg=t(sc["bg"]), **tight, **kw)
    for name in ("image", "alpha"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["radii"].numpy(), np.asarray(ref["radii"]),
                               rtol=1e-5, atol=1e-5)
    # the tighter clamp changed the Gaussians past 1.3·tan_fov
    assert not torch.equal(got["radii"], plain["radii"])


# ── the projection's dispatch: the kernel csrc/project.cu or the plain version ──

class _Tagged(torch.Tensor):
    """A tensor subclass, which the kernel does not read."""


def _dispatch_args(case):
    """The call's arguments: a small scene, the rotated camera and 0-dim
    tensors for fx, fy, cx, cy, changed as ``case`` says."""
    sc = scene(5)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    args = [t(sc["xyz"]), t(sc["scales"]), t(sc["quats"]), t(viewmat("rotated")),
            f32(F), f32(F), f32(W / 2), f32(H / 2), W, H]
    if case in ("needs_grad", "needs_grad_compiled", "camera_needs_grad"):
        args[0].requires_grad_(True)
    if case == "camera_needs_grad":
        args[3].requires_grad_(True)
    elif case == "numpy_intrinsics":
        args[4:8] = [np.float32(F), np.float32(F), np.float32(W / 2), np.float64(H / 2)]
    elif case == "python_intrinsics":
        args[4:8] = [F, F, W / 2, H / 2]
    elif case == "float64_scales":
        args[1] = args[1].double()
    elif case == "vector_focal":
        args[4] = f32([F])
    elif case == "tensor_subclass":
        args[0] = args[0].as_subclass(_Tagged)
    return args


# name: (the Gaussians on the card, grad mode, traced by torch.compile, what
# the call does). On the CPU ``_on_card`` is False; the other cases stand it
# in True and the launches ``_launch`` and ``_launch_backward`` in
# recorders, so that the gates decide. "kernel": the forward kernel alone;
# "kernel_grad": the forward under autograd, the backward kernel once
# ``.backward()`` runs.
DISPATCH_CASES = {
    "cpu_tensors": (False, False, False, "plain"),
    "needs_grad": (True, True, False, "kernel_grad"),
    "needs_grad_compiled": (True, True, True, "plain"),
    "camera_needs_grad": (True, True, False, "raises"),
    "compiled": (True, False, True, "plain"),
    "no_grad_mode": (True, False, False, "kernel"),
    "no_input_needs_grad": (True, True, False, "kernel"),
    "numpy_intrinsics": (True, False, False, "kernel"),
    "python_intrinsics": (True, False, False, "kernel"),
    "float64_scales": (True, False, False, "raises"),
    "vector_focal": (True, False, False, "raises"),
    "tensor_subclass": (True, False, False, "raises"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_project_gaussians_dispatch(case, monkeypatch):
    """CPU tensors and a torch.compile trace (fullgraph, so with no graph
    break) take the plain version and launch nothing, with the plain
    version's results. With the Gaussians on the card the call launches the
    forward kernel once, also with NumPy or Python numbers for the
    intrinsics; where means3d needs grad, under autograd, whose
    ``.backward()`` then launches the backward kernel once. Inputs it cannot
    read (float64 scales, a focal of shape [1], a tensor subclass, a viewmat
    that needs grad under grad mode) raise rather than take the plain
    version, which would run them."""
    on_card, grad_mode, compiled, does = DISPATCH_CASES[case]
    args = _dispatch_args(case)
    launched, launched_bwd = [], []
    monkeypatch.setattr(Pr, "_on_card", lambda means3d: on_card)
    monkeypatch.setattr(Pr, "_launch", lambda dev, *a: launched.append(a))
    monkeypatch.setattr(Pr, "_launch_backward", lambda dev, *a: launched_bwd.append(a))
    fn = (torch.compile(Pr.project_gaussians, backend="eager", fullgraph=True)
          if compiled else Pr.project_gaussians)
    before = Pr.project_gaussians.launches, Pr.project_gaussians.backward_launches
    with torch.set_grad_enabled(grad_mode):
        if does == "raises":
            with pytest.raises(ValueError, match="projection kernel reads"):
                fn(*args)
        else:
            got = fn(*args)
    kernel = does in ("kernel", "kernel_grad")
    assert Pr.project_gaussians.launches - before[0] == len(launched) == int(kernel)
    if does == "plain":
        ref = Pr.project_gaussians_plain(*args)
        for name in Pr.Projected._fields:
            assert torch.equal(getattr(got, name).detach(), getattr(ref, name).detach()), name
        assert got.means2d.requires_grad == (case != "cpu_tensors" and grad_mode)
    elif kernel:
        n = args[0].shape[0]
        assert [tuple(getattr(got, k).shape) for k in Pr.Projected._fields] == [
            (n, 2), (n,), (n, 3), (n,), (n,)]
        assert got.means2d.requires_grad == (does == "kernel_grad")
        assert not got.radii.requires_grad and not got.valid.requires_grad
        if does == "kernel_grad":
            assert not launched_bwd
            (got.means2d.sum() + got.conics.sum()).backward()
            assert args[0].grad is not None and args[0].grad.shape == (n, 3)
    assert Pr.project_gaussians.backward_launches - before[1] == len(launched_bwd) == int(
        does == "kernel_grad")
