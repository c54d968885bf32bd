"""The port's density control (segsplat_tpu_torch/train/densify.py) against the
JAX package's: ``densify_and_prune`` fed the JAX split noise gives the same
table, ``changed`` and ``overflow``; ``reset_opacity``, ``add_stats`` and
``zero_adam_rows`` (all groups, and the opacity group alone) match too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.train import densify as JD
from segsplat_tpu.train.trainer import OptimizationConfig as JaxOpt
from segsplat_tpu.train.trainer import init_state as jax_init_state
from segsplat_tpu.train.trainer import init_table_from_pcd as jax_init_table
from segsplat_tpu_torch.convert import train_state_from_jax_arrays
from segsplat_tpu_torch.train import densify as PD
from segsplat_tpu_torch.train.trainer import OptimizationConfig

FIELDS = PD.PARAM_FIELDS
CAP = 96


def _jax_state(n=40, capacity=CAP):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    table = jax_init_table(pts, rng.random((n, 3)).astype(np.float32), capacity)
    # spread the scales and opacities so clone, split and prune all happen
    table = dataclasses.replace(
        table,
        scaling=table.scaling + jnp.asarray(rng.normal(0, 1.0, (capacity, 3)), jnp.float32),
        opacity=jnp.asarray(rng.normal(-2, 3, (capacity, 1)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)), jnp.float32))
    state, _ = jax_init_state(table, JaxOpt(), spatial_lr_scale=1.0)
    stats = JD.DensifyStats(
        grad_accum=jnp.asarray(rng.random(capacity) * 4e-3, jnp.float32),
        denom=jnp.asarray(rng.integers(0, 3, capacity), jnp.float32),
        max_radii=jnp.asarray(rng.random(capacity) * 40, jnp.float32))
    return state._replace(stats=stats)


def _port(state):
    return train_state_from_jax_arrays(jax.tree.map(np.asarray, state), OptimizationConfig(),
                                       1.0, device="cpu")


def _assert_table(pt, jt):
    np.testing.assert_array_equal(pt.active.numpy(), np.asarray(jt.active))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(pt, f).detach().numpy(), np.asarray(getattr(jt, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("capacity,screen", [(CAP, False), (CAP, True), (48, False)])
def test_densify_and_prune_matches_jax(capacity, screen):
    state = _jax_state(capacity=capacity)
    key = jax.random.PRNGKey(7)
    ref_t, ref_s, ref_changed, ref_over = JD.densify_and_prune(
        state.table, state.stats, key, 2e-4, 0.005, 1.5, 0.01,
        max_screen_size_on=screen)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2 * capacity, 3))))
    ps = _port(state)
    got_t, got_s, got_changed, got_over = PD.densify_and_prune(
        ps.table, ps.stats, 2e-4, 0.005, 1.5, 0.01, max_screen_size_on=screen, noise=noise)
    _assert_table(got_t, ref_t)
    np.testing.assert_array_equal(got_changed.numpy(), np.asarray(ref_changed))
    assert int(got_over) == int(ref_over)
    assert not any(x.any() for x in got_s)
    if capacity == 48:
        assert int(got_over) > 0, "a small table must overflow"
    else:
        assert int(got_over) == 0 and got_changed.sum() > 0


def test_reset_opacity_and_add_stats_match_jax():
    state = _jax_state()
    ref_t, ref_changed = JD.reset_opacity(state.table)
    ps = _port(state)
    got_t, got_changed = PD.reset_opacity(ps.table)
    _assert_table(got_t, ref_t)
    np.testing.assert_array_equal(got_changed.numpy(), np.asarray(ref_changed))

    rng = np.random.default_rng(3)
    g = rng.normal(size=(CAP, 2)).astype(np.float32)
    vis = rng.random(CAP) < 0.5
    radii = (rng.random(CAP) * 30).astype(np.float32)
    ref = JD.add_stats(state.stats, jnp.asarray(g), jnp.asarray(vis), jnp.asarray(radii))
    got = PD.add_stats(ps.stats, torch.from_numpy(g), torch.from_numpy(vis),
                       torch.from_numpy(radii))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("fields", [None, ("opacity",)])
def test_zero_adam_rows_matches_jax(fields):
    state = _jax_state()
    rng = np.random.default_rng(4)
    # give every moment nonzero values first
    moments = jax.tree.map(lambda x: jnp.asarray(rng.random(x.shape) + 0.1, x.dtype)
                           if hasattr(x, "shape") and x.ndim >= 1 else x, state.opt_state)
    state = state._replace(opt_state=moments)
    changed = rng.random(CAP) < 0.3
    ref = JD.zero_adam_rows(state.opt_state, jnp.asarray(changed), CAP, fields=fields)
    ps = _port(state)
    PD.zero_adam_rows(ps.gauss_opt, torch.from_numpy(changed), fields=fields)
    ref_state = _port(state._replace(opt_state=ref))
    for f in FIELDS:
        p_got, p_ref = getattr(ps.table, f), getattr(ref_state.table, f)
        for key in ("exp_avg", "exp_avg_sq"):
            got = ps.gauss_opt.state[p_got][key].numpy()
            np.testing.assert_array_equal(got, ref_state.gauss_opt.state[p_ref][key].numpy())
            zeroed = (got[changed] == 0).all()
            assert zeroed == (fields is None or f == "opacity"), (f, key)


def test_grow_capacity_pads_inactive_rows():
    ps = _port(_jax_state())
    t, s = PD.grow_capacity(ps.table, ps.stats, CAP + 32)
    assert t.capacity == CAP + 32 and not t.active[CAP:].any()
    assert torch.equal(t.xyz[:CAP], ps.table.xyz.detach())
    assert (t.rotation[CAP:, 0] == 1).all() and s.denom.shape == (CAP + 32,)
