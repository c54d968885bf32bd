"""The port's dense blend backend (``rasterize(backend="dense")``,
segsplat_tpu_torch/ops/rasterize.py ``_blend_tiles``) held against JAX
``rasterize(backend="xla")``, the dense XLA blend it ports, forward and
gradients; and its tile helpers ``map_tile_chunks`` and ``tiles_to_image``.
Tolerances: image and alpha 1e-4 (abs + rel), as for the kernel path;
gradients rtol 5e-3, atol 2e-4·max|ref| (tests/test_blend_vjp.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.ops import rasterize as Rz
from segsplat_tpu_torch.ops import rasterize as Pr
from _torch_port import F, H, K_ODD, SCENES, W, odd_k_raster, scene, viewmat

# name: (scene kind, view, K, tile_chunk, opacity_cull). The 64×48 image has 12
# tiles: a tile_chunk of 5 leaves a last chunk of 2 (the JAX package pads it by
# wrapping tile ids).
DENSE_CASES = {
    "light_k128": ("light", "identity", 128, 64, False),
    "deep_k384_wrapped_chunks": ("deep", "rotated", 384, 5, False),
    "opaque_k256_cull": ("opaque", "identity", 256, 4, True),
}


def _inputs(kind: str, ch: int = 19):
    seed, n, log_scale, opac_range = SCENES[kind]
    sc = scene(seed, n, log_scale, opac_range, ch=ch)
    return [sc[k] for k in ("xyz", "scales", "quats", "opac", "colors")], sc["bg"]


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_matches_jax_xla(case):
    kind, view, K, chunk, cull = DENSE_CASES[case]
    arrays, bg = _inputs(kind)
    vm = viewmat(view)
    kw = dict(max_tiles_per_axis=4, max_per_tile=K, tile_chunk=chunk, opacity_cull=cull)
    ref = Rz.rasterize(*map(jnp.asarray, arrays), jnp.asarray(vm), F, F, W / 2, H / 2,
                       W, H, bg=jnp.asarray(bg), backend="xla", **kw)
    got = Pr.rasterize(*map(torch.from_numpy, arrays), torch.from_numpy(vm), F, F,
                       W / 2, H / 2, W, H, bg=torch.from_numpy(bg), backend="dense", **kw)
    for k in ("image", "alpha"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["radii"].numpy(), np.asarray(ref["radii"]), rtol=1e-5)
    np.testing.assert_array_equal(got["visible"].numpy(), np.asarray(ref["visible"]))
    assert int(got["tile_overflow"]) == int(ref["tile_overflow"])
    assert float(np.abs(np.asarray(ref["image"])).max()) > 0.1


def test_dense_gradients_match_jax_xla():
    """The loss and scene of tests/test_torch_rasterize_grad.py, through both
    dense blends, at 19 channels."""
    rng = np.random.default_rng(0)
    arrays, bg = _inputs("light")
    arrays = arrays + [np.zeros((arrays[0].shape[0], 2), np.float32), bg]
    gt = rng.random((H, W, 19)).astype(np.float32)
    vm = viewmat("rotated")
    kw = dict(max_tiles_per_axis=4, max_per_tile=128, tile_chunk=5)

    def jax_loss(xyz, scales, quats, opac, colors, offset, bg):
        out = Rz.rasterize(xyz, scales, quats, opac, colors, jnp.asarray(vm), F, F,
                           W / 2, H / 2, W, H, bg=bg, means2d_offset=offset,
                           backend="xla", **kw)
        return jnp.sum((out["image"] - gt) ** 2) + 0.3 * jnp.sum(out["alpha"] ** 2)

    ref_l, ref_g = jax.value_and_grad(jax_loss, argnums=tuple(range(7)))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    xyz, scales, quats, opac, colors, offset, bg_t = ts
    out = Pr.rasterize(xyz, scales, quats, opac, colors, torch.from_numpy(vm), F, F,
                       W / 2, H / 2, W, H, bg=bg_t, means2d_offset=offset,
                       backend="dense", **kw)
    loss = ((out["image"] - torch.from_numpy(gt)) ** 2).sum() + 0.3 * (out["alpha"] ** 2).sum()
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(ref_l), rtol=1e-4)
    names = ("xyz", "scales", "quats", "opac", "colors", "means2d_offset", "bg")
    for name, t, r in zip(names, ts, ref_g):
        r, g = np.asarray(r), t.grad.numpy()
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=2e-4 * (np.abs(r).max() + 1e-6),
                                   err_msg=f"grad mismatch: {name}")
        assert np.abs(g).max() > 0, f"grad identically zero: {name}"


def test_dense_matches_kernel_path_where_no_block_stops():
    """K = 128 on the light scene: one block, no early-out, so the dense blend
    and the kernel path's plain version composite the same pairs."""
    arrays, bg = _inputs("light", ch=32)
    t = list(map(torch.from_numpy, arrays))
    kw = dict(bg=torch.from_numpy(bg), max_tiles_per_axis=4, max_per_tile=128)
    args = (*t, torch.from_numpy(viewmat("identity")), F, F, W / 2, H / 2, W, H)
    dense = Pr.rasterize(*args, backend="dense", **kw)
    kernel = Pr.rasterize(*args, backend="cuda", **kw)
    for k in ("image", "alpha"):
        torch.testing.assert_close(dense[k], kernel[k], rtol=1e-4, atol=1e-4)
    for k in ("num_pairs", "tile_overflow"):
        assert torch.equal(dense[k], kernel[k])
    with pytest.raises(ValueError, match="backend"):
        Pr.rasterize(*args, backend="xla", **kw)


@pytest.mark.parametrize("ch", [19, 32])
def test_kernel_path_matches_dense_at_odd_k(ch):
    """K = 200, no multiple of 128: the kernel path (K1 and K2's plain versions
    here) against the dense blend, forward at 1e-4 and gradients at the
    tolerances above, with the cap cutting tiles inside a partial block."""
    img, alpha, over, grads = odd_k_raster("cpu", "cuda", ch)
    d_img, d_alpha, d_over, d_grads = odd_k_raster("cpu", "dense", ch)
    assert int(over) == int(d_over) > 0
    torch.testing.assert_close(img, d_img, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alpha, d_alpha, rtol=1e-4, atol=1e-4)
    for name, r in d_grads.items():
        g, r = grads[name].numpy(), r.numpy()
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=2e-4 * (np.abs(r).max() + 1e-6),
                                   err_msg=f"grad mismatch at K={K_ODD}: {name}")
        assert np.abs(g).max() > 0, f"grad identically zero: {name}"


def test_tile_helpers_match_jax():
    rng = np.random.default_rng(3)
    ty_n, tx_n = 3, 4
    x = rng.standard_normal((ty_n * tx_n, 16, 16, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        Pr.tiles_to_image(torch.from_numpy(x), ty_n, tx_n, 40, 50).numpy(),
        np.asarray(Rz.tiles_to_image(jnp.asarray(x), ty_n, tx_n, 40, 50)))

    table = rng.standard_normal((11, 3)).astype(np.float32)
    ref = Rz.map_tile_chunks(lambda ids: (jnp.asarray(table)[ids], ids * 2), 11, 4)
    got = Pr.map_tile_chunks(lambda ids: (torch.from_numpy(table)[ids], ids * 2), 11, 4,
                             "cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
