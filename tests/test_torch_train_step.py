"""One train step of the port (segsplat_tpu_torch/train/trainer.py) against the
JAX package's, from the same state converted with
``convert.train_state_from_jax_arrays``. The JAX side trains through its dense
XLA blend (``backend="xla"``, its own training path on the CPU), which
tests/test_blend_vjp.py ties to the Pallas VJP, and which
tests/test_torch_rasterize_grad.py ties to the port's.

  * every loss term at 1e-4 relative;
  * the parameter, codebook and screen-space gradients at rtol 5e-3,
    atol 2e-4·max|ref| (tests/test_blend_vjp.py's tolerance);
  * the Adam update on the SAME gradients at 1e-6 — not the post-step
    parameters alone: with eps = 1e-15 a gradient near 0 whose sign differs in
    the last bit moves a parameter by the whole learning rate.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.core.types import Camera as JaxCamera
from segsplat_tpu.train import trainer as JT
from segsplat_tpu_torch.convert import train_state_from_jax_arrays
from segsplat_tpu_torch.core.types import Camera
from segsplat_tpu_torch.train import trainer as PT
from segsplat_tpu_torch.train.densify import PARAM_FIELDS
from _torch_port import F, H, W

# updates already taken, so Adam's moments and the xyz rate are not trivial.
# Late in training on purpose: optax forms Adam's bias correction 1 - b2^t in
# float32 from b2 = 0.999 rounded to float32, which is off by 4e-6 to 5e-6
# relative for t up to a few thousand (torch forms it in double); by t = 10^4
# b2^t is negligible and the two agree to float32 rounding.
STEP = 10_000


def _setup():
    rng = np.random.default_rng(0)
    n, cap = 300, 384
    pts = (rng.random((n, 3)) * np.array([3.0, 2.0, 2.0])
           + np.array([-1.5, -1.0, 1.5])).astype(np.float32)
    table = JT.init_table_from_pcd(pts, rng.random((n, 3)).astype(np.float32), cap)
    # anisotropic scales: with the isotropic initial ones the rotation's true
    # gradient is 0 and only float noise would be compared
    table = dataclasses.replace(
        table, active_sh_degree=jnp.asarray(2, jnp.int32),
        scaling=table.scaling + jnp.asarray(rng.normal(0, 0.5, (cap, 3)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.2, table.features_rest.shape), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(cap, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(0, 1, (cap, 1)), jnp.float32))
    cfg = JT.OptimizationConfig(num_classes=16)
    state, opts = JT.init_state(table, cfg, spatial_lr_scale=2.0, seed=0)
    # Adam moments and counts as after STEP updates
    fill = lambda x: (jnp.asarray(rng.random(x.shape) * 1e-3, x.dtype) if x.ndim >= 1
                      else jnp.asarray(STEP, x.dtype))
    state = state._replace(opt_state=jax.tree.map(fill, state.opt_state),
                           cls_opt_state=jax.tree.map(fill, state.cls_opt_state),
                           step=jnp.asarray(STEP, jnp.int32))
    fov_x, fov_y = 2 * math.atan(W / (2 * F)), 2 * math.atan(H / (2 * F))
    # off the origin, where the inactive rows sit: the SH view direction of a
    # Gaussian at the camera centre has a NaN gradient in both packages
    R = np.eye(3, dtype=np.float32)
    T = np.array([0.05, -0.02, 0.1], np.float32)
    jcam = JaxCamera(R=jnp.asarray(R), T=jnp.asarray(T), fov_x=jnp.asarray(fov_x),
                     fov_y=jnp.asarray(fov_y), width=W, height=H)
    pcam = Camera(R=torch.from_numpy(R), T=torch.from_numpy(T), fov_x=torch.tensor(fov_x),
                  fov_y=torch.tensor(fov_y), width=W, height=H)
    gt = rng.random((3, H, W)).astype(np.float32)
    gto = ((np.arange(H)[:, None] // 12) * 4 + np.arange(W)[None, :] // 16).astype(np.int32)
    return state, opts, cfg, jcam, pcam, gt, gto


@pytest.fixture(scope="module")
def step_pair():
    state, opts, cfg, jcam, pcam, gt, gto = _setup()
    raster = dict(max_tiles_per_axis=4, max_per_tile=128)
    jkw = dict(raster, backend="xla", tile_chunk=16)
    bg = jnp.zeros(3)
    key = jax.random.PRNGKey(11)
    params = JT.table_params(state.table)

    def loss_fn(params, code_book, offset):
        t = JT.with_params(state.table, params)
        return JT.compute_losses(t, code_book, jcam, jnp.asarray(gt), jnp.asarray(gto), bg,
                                 key, cfg, offset, jkw)

    (_, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        params, state.code_book, jnp.zeros((state.table.capacity, 2)))
    g_params, g_cb, _ = ref_grads
    ref_updates = (opts[0].update(g_params, state.opt_state, params)[0],
                   opts[1].update(g_cb, state.cls_opt_state, state.code_book)[0])

    pcfg = PT.OptimizationConfig(num_classes=16)
    ps = train_state_from_jax_arrays(jax.tree.map(np.asarray, state), pcfg, 2.0,
                                     device="cpu")
    idx = torch.from_numpy(np.array(jax.random.randint(jax.random.split(key)[0], (32768,),
                                                       0, H * W))).long()
    offset = torch.zeros((ps.table.capacity, 2), requires_grad=True)
    total, aux = PT.compute_losses(ps.table, ps.code_book, pcam, torch.from_numpy(gt),
                                   torch.from_numpy(gto), torch.zeros(3), pcfg, offset,
                                   raster, idx=idx)
    total.backward()
    return dict(ref_aux=ref_aux, ref_grads=ref_grads, ref_updates=ref_updates,
                ps=ps, aux=aux, offset=offset)


def _grad_close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=2e-4 * (np.abs(ref).max() + 1e-6),
                               err_msg=name)


def test_loss_terms_match_jax(step_pair):
    aux, ref = step_pair["aux"], step_pair["ref_aux"]
    for k in ("l1", "dssim", "contrastive", "cls", "clustering", "reg", "total", "psnr"):
        np.testing.assert_allclose(float(aux[k].detach()), float(ref[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(aux["radii"].detach().numpy(), np.asarray(ref["radii"]))
    assert float(aux["cls"].detach()) > 0 and float(aux["clustering"].detach()) > 0


def test_gradients_match_jax(step_pair):
    g_params, g_cb, g_off = step_pair["ref_grads"]
    ps = step_pair["ps"]
    for f in PARAM_FIELDS:
        got = getattr(ps.table, f).grad.numpy()
        _grad_close(got, g_params[f], f)
        assert np.abs(got).max() > 0, f"gradient identically zero: {f}"
    _grad_close(ps.code_book.grad.numpy(), g_cb, "code_book")
    _grad_close(step_pair["offset"].grad.numpy(), g_off, "means2d_offset")


def test_adam_update_on_the_same_gradients_matches_optax(step_pair):
    """optax's update against torch's, both from the same moments and count:
    the port's parameters are zeroed first, so after the step they hold the
    update itself (Adam's update does not depend on the parameter values)."""
    ps = step_pair["ps"]
    g_params, g_cb, _ = step_pair["ref_grads"]
    ref_params, ref_cb = step_pair["ref_updates"]
    tensors = [getattr(ps.table, f) for f in PARAM_FIELDS] + [ps.code_book]
    grads = [g_params[f] for f in PARAM_FIELDS] + [g_cb]
    refs = [ref_params[f] for f in PARAM_FIELDS] + [ref_cb]
    with torch.no_grad():
        for t, g in zip(tensors, grads):
            t.zero_()
            t.grad = torch.from_numpy(np.array(g))
    assert ps.step == STEP
    PT.apply_updates(ps)
    for name, t, ref in zip(PARAM_FIELDS + ("code_book",), tensors, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=name)
        assert np.abs(ref).max() > 0, name


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_colors_match_jax(degree):
    from segsplat_tpu.render import sh_colors as jax_sh_colors
    from segsplat_tpu_torch.render import sh_colors

    state = _setup()[0]
    table = dataclasses.replace(state.table, active_sh_degree=jnp.asarray(degree, jnp.int32))
    campos = np.array([0.3, -0.2, 0.1], np.float32)
    ref = np.asarray(jax_sh_colors(table, jnp.asarray(campos)))
    pt = train_state_from_jax_arrays(jax.tree.map(np.asarray, state._replace(table=table)),
                                     PT.OptimizationConfig(), 1.0, device="cpu").table
    got = sh_colors(pt, torch.from_numpy(campos)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_init_table_from_pcd_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    ref = JT.init_table_from_pcd(pts, cols, 768, seed=3)
    got = PT.init_table_from_pcd(pts, cols, 768, seed=3, device="cpu")
    assert got.active_sh_degree == int(ref.active_sh_degree) == 0
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_train_step_matches_jax_make_train_step():
    """The whole step: JAX ``make_train_step`` and the port's ``train_step``
    from the same state, with the same contrastive sample. Metrics at 1e-4,
    the densify statistics at the gradient tolerance, and the post-step
    parameters to within the update's own gradient tolerance (plus one float32
    rounding of the parameter)."""
    state, opts, cfg, jcam, pcam, gt, gto = _setup()
    raster = dict(max_tiles_per_axis=4, max_per_tile=128)
    key = jax.random.PRNGKey(5)
    ref_state, ref_metrics = JT.make_train_step(cfg, opts, dict(raster, backend="xla",
                                                                tile_chunk=16))(
        state, jcam, jnp.asarray(gt), jnp.asarray(gto), jnp.zeros(3), key)
    ps = train_state_from_jax_arrays(jax.tree.map(np.asarray, state),
                                     PT.OptimizationConfig(num_classes=16), 2.0, device="cpu")
    idx = torch.from_numpy(np.array(jax.random.randint(jax.random.split(key)[0], (32768,),
                                                       0, H * W))).long()
    metrics = PT.make_train_step(PT.OptimizationConfig(num_classes=16), raster)(
        ps, pcam, torch.from_numpy(gt), torch.from_numpy(gto), torch.zeros(3), idx=idx)
    assert ps.step == int(ref_state.step) == STEP + 1
    for k in ("l1", "dssim", "contrastive", "cls", "clustering", "reg", "total", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    _grad_close(ps.stats.grad_accum.numpy(), ref_state.stats.grad_accum, "grad_accum")
    np.testing.assert_array_equal(ps.stats.denom.numpy(), np.asarray(ref_state.stats.denom))
    np.testing.assert_array_equal(ps.stats.max_radii.numpy(),
                                  np.asarray(ref_state.stats.max_radii))
    for f in PARAM_FIELDS:
        old = np.asarray(getattr(state.table, f))
        new_ref = np.asarray(getattr(ref_state.table, f))
        upd = new_ref - old
        tol = (5e-3 * np.abs(upd) + 2e-4 * np.abs(upd).max()
               + 2 * np.spacing(np.abs(old).astype(np.float32)))
        got = getattr(ps.table, f).detach().numpy()
        assert (np.abs(got - new_ref) <= tol).all(), f


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_train_step_at_k200_matches_jax(backend):
    """K = 200 is no multiple of 128. The JAX package trains at that K only on
    its dense ``backend="xla"``; the port trains on either backend (the
    kernels' plain versions here), and its step matches the JAX step at the
    tolerances above."""
    from segsplat_tpu_torch.pipeline.train import TrainRunConfig, raster_kw_for

    state, opts, cfg, jcam, pcam, gt, gto = _setup()
    raster = raster_kw_for(TrainRunConfig(raster_max_tiles_per_axis=4,
                                          raster_max_per_tile=200, raster_tile_chunk=16,
                                          raster_backend=backend))
    assert raster == dict(max_tiles_per_axis=4, max_per_tile=200, tile_chunk=16,
                          backend=backend)
    key = jax.random.PRNGKey(5)
    ref_state, ref_metrics = JT.make_train_step(cfg, opts, dict(raster, backend="xla"))(
        state, jcam, jnp.asarray(gt), jnp.asarray(gto), jnp.zeros(3), key)
    ps = train_state_from_jax_arrays(jax.tree.map(np.asarray, state),
                                     PT.OptimizationConfig(num_classes=16), 2.0, device="cpu")
    idx = torch.from_numpy(np.array(jax.random.randint(jax.random.split(key)[0], (32768,),
                                                       0, H * W))).long()
    metrics = PT.make_train_step(PT.OptimizationConfig(num_classes=16), raster)(
        ps, pcam, torch.from_numpy(gt), torch.from_numpy(gto), torch.zeros(3), idx=idx)
    for k in ("l1", "dssim", "contrastive", "cls", "clustering", "reg", "total", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    _grad_close(ps.stats.grad_accum.numpy(), ref_state.stats.grad_accum, "grad_accum")
    np.testing.assert_array_equal(ps.stats.denom.numpy(), np.asarray(ref_state.stats.denom))
    np.testing.assert_array_equal(ps.stats.max_radii.numpy(),
                                  np.asarray(ref_state.stats.max_radii))
    for f in PARAM_FIELDS:
        old = np.asarray(getattr(state.table, f))
        new_ref = np.asarray(getattr(ref_state.table, f))
        upd = new_ref - old
        tol = (5e-3 * np.abs(upd) + 2e-4 * np.abs(upd).max()
               + 2 * np.spacing(np.abs(old).astype(np.float32)))
        got = getattr(ps.table, f).detach().numpy()
        assert (np.abs(got - new_ref) <= tol).all(), f
