"""Gradients of the port's rasterize (K1 forward, K2 backward, torch autograd
through projection, payload build and gather) held against JAX
``rasterize(backend="pallas")`` — the custom-VJP Pallas blend, in interpret
mode — on the scene and loss of tests/test_blend_vjp.py at the training raster's
19 channels, with that test's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu.ops import rasterize as Rz
from segsplat_tpu_torch.ops import rasterize as Pr

CH = 19
W, H, F = 64, 48, 60.0
NAMES = ("xyz", "scales", "quats", "opac", "colors", "means2d_offset", "bg")


def _inputs():
    rng = np.random.default_rng(0)
    n = 400
    xyz = rng.random((n, 3)) * np.array([3.0, 2.0, 2.0]) + np.array([-1.5, -1.0, 1.5])
    scales = np.exp(rng.normal(-2.5, 0.3, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    arrays = [xyz, scales, q, rng.uniform(0.3, 0.9, (n,)), rng.random((n, CH)),
              np.zeros((n, 2)), rng.random(CH)]
    gt = rng.random((H, W, CH)).astype(np.float32)
    return [np.asarray(a, np.float32) for a in arrays], gt


def test_rasterize_gradients_match_jax_pallas():
    arrays, gt = _inputs()
    common = dict(max_tiles_per_axis=4, max_per_tile=128)
    vm = np.eye(4, dtype=np.float32)

    def jax_loss(xyz, scales, quats, opac, colors, offset, bg):
        out = Rz.rasterize(xyz, scales, quats, opac, colors, jnp.asarray(vm), F, F,
                           W / 2, H / 2, W, H, bg=bg, means2d_offset=offset,
                           backend="pallas", **common)
        return jnp.sum((out["image"] - gt) ** 2) + 0.3 * jnp.sum(out["alpha"] ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref_l, ref_g = jax.value_and_grad(jax_loss, argnums=tuple(range(7)))(
            *map(jnp.asarray, arrays))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    xyz, scales, quats, opac, colors, offset, bg = ts
    out = Pr.rasterize(xyz, scales, quats, opac, colors, torch.from_numpy(vm), F, F,
                       W / 2, H / 2, W, H, bg=bg, means2d_offset=offset, **common)
    loss = ((out["image"] - torch.from_numpy(gt)) ** 2).sum() + 0.3 * (out["alpha"] ** 2).sum()
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(ref_l), rtol=1e-4)
    for name, t, r in zip(NAMES, ts, ref_g):
        r, g = np.asarray(r), t.grad.numpy()
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=2e-4 * (np.abs(r).max() + 1e-6),
                                   err_msg=f"grad mismatch: {name}")
        assert np.abs(g).max() > 0, f"grad identically zero: {name}"


def test_rasterize_without_grad_is_unchanged():
    """Inputs that need no gradient still render through the same blend."""
    arrays, _ = _inputs()
    t = [torch.from_numpy(a) for a in arrays]
    kw = dict(max_tiles_per_axis=4, max_per_tile=128)
    vm = torch.eye(4)
    a = Pr.rasterize(*t[:5], vm, F, F, W / 2, H / 2, W, H, bg=t[6], **kw)
    b = Pr.rasterize(*t[:5], vm, F, F, W / 2, H / 2, W, H, bg=t[6],
                     means2d_offset=t[5], **kw)
    assert not a["image"].requires_grad
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["alpha"], b["alpha"])
