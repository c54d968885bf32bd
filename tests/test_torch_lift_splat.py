"""The splat first-hit lift of the port (segsplat_tpu_torch/ops/lift_splat.py)
against the JAX package's on the same seeded inputs, on the CPU: the dual
binning's order, rank_sorted, offsets and overflow exact (with ties in depth
and span, an overflowing big budget, and both fall-backs to the single-pass
bin), hit images exact, ``lift_view_splat``'s counts and overflow exact and
sums at rtol/atol 1e-5, also as ``splat_geometry`` then ``splat_accumulate``;
and against the port's own DDA (≥ 97 % of pixels) and
``first_hit_voxels_splat`` + ``scatter_features``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy, occupied_voxels
from segsplat_tpu.ops import lift_splat as JS
from segsplat_tpu_torch.ops import lift as PL
from segsplat_tpu_torch.ops import lift_splat as PS

W, H = 48, 40
INTR = np.array([45.0, 45.0, W / 2, H / 2], np.float32)
DMIN, DMAX = 0.05, 8.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _voxels():
    return occupied_voxels(lift_occupancy(np.random.default_rng(0)), LIFT_VS, LIFT_ORIGIN)


def _args(view, w=W, h=H, intr=INTR, scale=1.0):
    """The positional arguments of first_hit_voxels_splat for both packages."""
    centers, ids = _voxels()
    c2w = lift_camera(view, 3, scale)
    inc = np.float32(LIFT_VS * 0.5)
    jax_args = (jnp.asarray(centers), jnp.asarray(ids), jnp.asarray(c2w), jnp.asarray(intr),
                jnp.asarray(LIFT_VS, jnp.float32), DMIN, DMAX, jnp.asarray(inc), w, h)
    port_args = (_t(centers), _t(ids), _t(c2w), _t(intr),
                 torch.tensor(LIFT_VS, dtype=torch.float32), DMIN, DMAX, _t(inc), w, h)
    return jax_args, port_args


def _screen_boxes(n, rng, width, height, depth_levels=5):
    """Seeded screen boxes for the binning alone: depths on a few levels and
    integer radii, so the stable sorts meet many ties; some invalid."""
    means2d = rng.uniform(-20, max(width, height) + 20, (n, 2)).astype(np.float32)
    radius = rng.choice([1.0, 3.0, 9.0, 17.0, 40.0], n, p=[.4, .3, .15, .1, .05])
    depth = rng.integers(1, depth_levels + 1, n).astype(np.float32)
    valid = rng.random(n) > 0.1
    return means2d, radius.astype(np.float32), depth, valid


@pytest.mark.parametrize("case", ["budget_fits", "budget_overflows", "m_small_fallback",
                                  "key_bits_fallback"])
def test_dual_bin_matches_jax_exactly(case):
    rng = np.random.default_rng(7)
    width, height, m, budget, n = 160, 128, 6, 1500, 3000
    if case == "budget_overflows":
        budget = 100
    elif case == "m_small_fallback":
        m = 2
    elif case == "key_bits_fallback":      # 2^20 tiles: tile + rank bits exceed 32
        width = height = 16 * 1024
    boxes = _screen_boxes(n, rng, width, height)
    ref = JS._bin_voxels_dual(*(jnp.asarray(b) for b in boxes), width, height, m, budget)
    got = PS._bin_voxels_dual(*(_t(b) for b in boxes), width, height, m, budget)
    for name, g, r in zip(("order", "rank_sorted", "offsets"), got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert got[3] == tuple(ref[3])
    assert int(got[4]) == int(ref[4])
    if case == "budget_overflows":
        assert int(got[4]) > 0
    elif case == "budget_fits":
        assert int(got[4]) == 0


@pytest.mark.parametrize("view", [0, 1, 2])
def test_projection_matches_jax(view):
    centers, _ = _voxels()
    c2w = lift_camera(view, 3)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = c2w[:3, :3].T
    w2c[:3, 3] = -c2w[:3, :3].T @ c2w[:3, 3]
    half = np.float32(LIFT_VS * 0.5)
    ref = JS._project_voxels(jnp.asarray(centers), jnp.asarray(half), jnp.asarray(w2c),
                             jnp.asarray(INTR), W, H, DMAX)
    got = PS._project_voxels(_t(centers), _t(half), _t(w2c), _t(INTR), W, H, DMAX)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("view", [0, 1, 2])
@pytest.mark.parametrize("dual_bin", [False, True])
def test_first_hit_splat_matches_jax_exactly(view, dual_bin):
    jax_args, port_args = _args(view)
    kw = dict(max_tiles_per_axis=4, max_per_tile=64, tile_chunk=4, dual_bin=dual_bin)
    ref = np.asarray(JS.first_hit_voxels_splat(*jax_args, **kw))
    got = PS.first_hit_voxels_splat(*port_args, **kw)
    assert got.dtype == torch.int32 and (ref > 0).mean() > 0.3
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("view", [0, 1, 2])
def test_splat_agrees_with_the_ports_dda(view):
    _, port_args = _args(view)
    centers, ids, c2w, intr, vs, dmin, dmax, inc, w, h = port_args
    occ = _t(lift_occupancy(np.random.default_rng(0)))
    steps = PL.default_max_steps(w, h, INTR[0], INTR[1], dmin, dmax, float(inc))
    dda = PL.first_hit_voxels(occ, c2w, intr, _t(LIFT_ORIGIN), vs, dmin, dmax, inc, w, h,
                              steps)
    splat = PS.first_hit_voxels_splat(*port_args, max_tiles_per_axis=4, max_per_tile=64,
                                      tile_chunk=4)
    assert (dda > 0).float().mean() > 0.3
    assert (dda == splat).float().mean() > 0.97


@pytest.mark.parametrize("view,scale,split", [
    pytest.param(1, 1.0, False, id="1-1.0"), pytest.param(0, 0.6, False, id="0-0.6"),
    pytest.param(2, 0.6, False, id="2-0.6"), pytest.param(1, 1.0, True, id="1-1.0-split"),
    pytest.param(0, 0.6, True, id="0-0.6-split"), pytest.param(2, 0.6, True, id="2-0.6-split")])
def test_lift_view_splat_matches_jax(view, scale, split):
    """Close-up cameras (scale 0.6, m = 6, K = 128 on a 64×48 image) give
    multi-tile footprints for the dual bin's big set. Split: the view's
    ``splat_geometry`` once, then ``splat_accumulate`` on two maps, each held
    against JAX's ``lift_view_splat``."""
    w, h = (64, 48) if scale != 1.0 else (W, H)
    intr = np.array([70.0, 70.0, w / 2, h / 2], np.float32) if scale != 1.0 else INTR
    jax_args, port_args = _args(view, w, h, intr, scale)
    C = 24
    rng = np.random.default_rng(view)
    maps = [rng.random((h, w, C)).astype(np.float32) for _ in range(2 if split else 1)]
    num_ids = int(port_args[1].max()) + 1
    kw = dict(max_tiles_per_axis=6 if scale != 1.0 else 4,
              max_per_tile=128 if scale != 1.0 else 64, tile_chunk=4)
    # a big budget of a quarter of the voxels: the selection by span matters
    for dual in (dict(dual_bin=True, big_budget=num_ids // 4), dict(dual_bin=False)):
        geo = PS.splat_geometry(*port_args, **dual, **kw) if split else None
        for feats in maps:
            rs, rc, rof = JS.lift_view_splat(*jax_args[:8], jnp.asarray(feats), num_ids,
                                             *jax_args[8:], **dual, **kw)
            s, c, of = (PS.splat_accumulate(geo, _t(feats), num_ids) if split else
                        PS.lift_view_splat(*port_args[:8], _t(feats), num_ids,
                                           *port_args[8:], **dual, **kw))
            assert s.dtype == torch.float32 and c.dtype == torch.int32
            np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
            np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
            assert int(of) == int(rof) and int(c.sum()) > 0
    assert int(of) == 0
    # the fused sums equal the hit image scattered, and the same bits twice
    hits = PS.first_hit_voxels_splat(*port_args, **kw)
    ref_s, ref_c = PL.scatter_features(_t(feats), hits, num_ids)
    np.testing.assert_array_equal(c.numpy(), ref_c.numpy())
    np.testing.assert_allclose(s.numpy(), ref_s.numpy(), rtol=1e-5, atol=1e-5)
    s2, c2, _ = PS.lift_view_splat(*port_args[:8], _t(feats), num_ids, *port_args[8:],
                                   dual_bin=False, **kw)
    assert torch.equal(s, s2) and torch.equal(c, c2)


def test_truncation_is_reported_as_jax_reports_it():
    """A per-tile K of 8, a tiny big budget and a pair cap: the overflow and
    the truncated hits equal JAX's, also through ``splat_geometry`` then
    ``splat_accumulate`` on two maps, with either binning."""
    jax_args, port_args = _args(0, 64, 48, np.array([70.0, 70.0, 32, 24], np.float32), 0.6)
    feats = np.random.default_rng(5).random((48, 64, 4)).astype(np.float32)
    num_ids = int(port_args[1].max()) + 1
    kw = dict(max_tiles_per_axis=6, max_per_tile=8, tile_chunk=4, big_budget=3)
    rs, rc, rof = JS.lift_view_splat(*jax_args[:8], jnp.asarray(feats), num_ids,
                                     *jax_args[8:], **kw)
    s, c, of = PS.lift_view_splat(*port_args[:8], _t(feats), num_ids, *port_args[8:], **kw)
    assert int(of) == int(rof) > 0
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    # split, with either binning: the geometry once, the accumulation on two maps
    other = np.random.default_rng(6).random((48, 64, 4)).astype(np.float32)
    for dual_bin in (True, False):
        geo = PS.splat_geometry(*port_args, dual_bin=dual_bin, **kw)
        for f in (feats, other):
            rs, rc, rof = JS.lift_view_splat(*jax_args[:8], jnp.asarray(f), num_ids,
                                             *jax_args[8:], dual_bin=dual_bin, **kw)
            s, c, of = PS.splat_accumulate(geo, _t(f), num_ids)
            assert int(of) == int(rof) > 0
            np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
            np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    capped = dict(max_tiles_per_axis=4, max_per_tile=64, tile_chunk=4, pair_cap=500)
    np.testing.assert_array_equal(
        PS.first_hit_voxels_splat(*port_args, **capped).numpy(),
        np.asarray(JS.first_hit_voxels_splat(*jax_args, **capped)))

