"""The DDA first-hit lift of the port (segsplat_tpu_torch/ops/lift.py) against
the JAX package's on the same seeded scenes, on the CPU: hit images, counts and
predictions exact, sums at rtol/atol 1e-5, means at 1e-6, the same bits on
two runs; against the reference kernel's numpy transcription
(tests/oracles.py) on ≥ 99.5 % of pixels; and the golden artifacts of
tests/golden/ regenerated through the port and diffed with
segsplat_tpu.eval.parity, as tests/test_parity_golden.py does for JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy
from segsplat_tpu.ops import lift as JL
from segsplat_tpu_torch.ops import lift as PL
from tests import oracles

DMIN, DMAX = 0.01, 3.0


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _scenes():
    """(name, occ, c2w, intr, origin, vs, W, H, depth range): the oracle scene
    of tests/test_lift.py, and three views of tests/test_lift_splat.py's grid."""
    occ, c2w, intr, origin, vs, W, H = oracles.make_test_scene(np.random.default_rng(3))
    out = [("slab", occ, c2w, intr, origin, vs, W, H, DMIN, DMAX)]
    occ2 = lift_occupancy(np.random.default_rng(0))
    W2, H2 = 48, 40
    intr2 = np.array([45.0, 45.0, W2 / 2, H2 / 2], np.float32)
    for v in range(3):
        out.append((f"grid{v}", occ2, lift_camera(v, 3), intr2, LIFT_ORIGIN, LIFT_VS,
                    W2, H2, 0.05, 8.0))
    return out


SCENES = {s[0]: s[1:] for s in _scenes()}


def _hits(occ, c2w, intr, origin, vs, W, H, dmin, dmax):
    inc = vs * 0.5
    steps = PL.default_max_steps(W, H, intr[0], intr[1], dmin, dmax, inc)
    assert steps == JL.default_max_steps(W, H, intr[0], intr[1], dmin, dmax, inc)
    ref = np.asarray(JL.first_hit_voxels(
        jnp.asarray(occ), jnp.asarray(c2w), jnp.asarray(intr), jnp.asarray(origin),
        jnp.asarray(vs, jnp.float32), dmin, dmax, jnp.asarray(inc, jnp.float32), W, H,
        steps))
    got = PL.first_hit_voxels(_t(occ), _t(c2w), _t(intr), _t(origin),
                              torch.tensor(vs, dtype=torch.float32), dmin, dmax,
                              torch.tensor(inc, dtype=torch.float32), W, H, steps)
    return got, ref


@pytest.mark.parametrize("name", sorted(SCENES))
def test_first_hit_matches_jax_exactly(name):
    got, ref = _hits(*SCENES[name])
    assert got.dtype == torch.int32 and (ref > 0).sum() > 20
    np.testing.assert_array_equal(got.numpy(), ref)


def test_first_hit_matches_the_cuda_oracle():
    occ, c2w, intr, origin, vs, W, H, dmin, dmax = SCENES["slab"]
    oracle = oracles.oracle_first_hit(occ, c2w, intr, origin, vs, dmin, dmax, vs * 0.5, W, H)
    got, _ = _hits(*SCENES["slab"])
    assert (got.numpy() == oracle).mean() > 0.995


def test_pixel_ray_dirs_match_jax():
    got = PL.pixel_ray_dirs(30, 20, 25.0, 27.0, 14.5, 9.0, device="cpu")
    ref = np.asarray(JL.pixel_ray_dirs(30, 20, 25.0, 27.0, 14.5, 9.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)


def test_scatter_matches_jax_and_oracle():
    occ, c2w, intr, origin, vs, W, H, dmin, dmax = SCENES["slab"]
    num_ids = int(occ.max()) + 1
    hits = oracles.oracle_first_hit(occ, c2w, intr, origin, vs, dmin, dmax, vs / 2, W, H)
    feats = np.random.default_rng(0).normal(size=(H, W, 8)).astype(np.float32)
    s, c = PL.scatter_features(_t(feats), _t(hits), num_ids)
    rs, rc = JL.scatter_features(jnp.asarray(feats), jnp.asarray(hits), num_ids)
    assert c.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    os_, oc = oracles.oracle_scatter(feats, hits, num_ids)
    np.testing.assert_array_equal(c.numpy(), oc)
    np.testing.assert_allclose(s.numpy(), os_, rtol=1e-5, atol=1e-5)
    preds = np.random.default_rng(1).integers(-5, 9, (H, W)).astype(np.int32)
    np.testing.assert_array_equal(
        PL.scatter_predictions(_t(preds), _t(hits), num_ids).numpy(),
        np.asarray(JL.scatter_predictions(jnp.asarray(preds), jnp.asarray(hits), num_ids)))


@pytest.mark.parametrize("name", ["slab", "grid1"])
def test_lift_view_and_mean_match_jax(name):
    occ, c2w, intr, origin, vs, W, H, dmin, dmax = SCENES[name]
    num_ids = int(occ.max()) + 1
    feats = np.random.default_rng(2).normal(size=(H, W, 16)).astype(np.float32)
    s, c = PL.lift_view(feats, _t(occ), c2w, intr, origin, vs, num_ids, depth_min=dmin,
                        depth_max=dmax)
    rs, rc = JL.lift_view(feats, occ, c2w, intr, origin, vs, num_ids, depth_min=dmin,
                          depth_max=dmax)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(PL.mean_features(s, c).numpy(),
                               np.asarray(JL.mean_features(rs, rc)), rtol=1e-6, atol=1e-6)
    # the same bits on a second run
    s2, c2 = PL.lift_view(feats, _t(occ), c2w, intr, origin, vs, num_ids, depth_min=dmin,
                          depth_max=dmax)
    assert torch.equal(s, s2) and torch.equal(c, c2)


def test_lift_views_scan_matches_jax():
    occ, c2w, intr, origin, vs, W, H, dmin, dmax = SCENES["slab"]
    num_ids = int(occ.max()) + 1
    V = 3
    feats = np.random.default_rng(3).normal(size=(V, H, W, 8)).astype(np.float32)
    c2ws = np.tile(c2w, (V, 1, 1)).astype(np.float32)
    c2ws[1, 0, 3] += 0.05
    c2ws[2, 1, 3] -= 0.05
    intrs = np.tile(intr, (V, 1)).astype(np.float32)
    inc = np.float32(vs / 2)
    steps = JL.default_max_steps(W, H, intr[0], intr[1], dmin, dmax, inc)
    rs, rc = JL.lift_views_scan(jnp.asarray(feats), jnp.asarray(occ), jnp.asarray(c2ws),
                                jnp.asarray(intrs), jnp.asarray(origin), jnp.asarray(vs),
                                dmin, dmax, jnp.asarray(inc), num_ids, steps, W, H)
    s, c = PL.lift_views_scan(_t(feats), _t(occ), _t(c2ws), _t(intrs), _t(origin),
                              torch.tensor(vs, dtype=torch.float32), dmin, dmax,
                              torch.tensor(inc), num_ids, steps, W, H)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)


def test_goldens_regenerated_through_the_port_diff_clean(tmp_path):
    """tests/test_parity_golden.py's fixture with the port's DDA, scatter,
    artifact writer and grid PLY writer; diffed against tests/golden/."""
    import os

    from segsplat_tpu.eval.parity import compare_voxel_features, compare_voxel_grids
    from segsplat_tpu_torch.io.artifacts import save_voxel_features
    from segsplat_tpu_torch.io.ply import write_voxel_grid_ply
    from tests.make_goldens import (CHANNELS, DEPTH_MAX, DEPTH_MIN, GOLD_DIR, id_coords,
                                    scene_inputs)

    occ, views, intr, origin, vs, W, H, feats = scene_inputs()
    coords = id_coords(occ)
    num_ids = coords.shape[0] + 1
    centers = (origin + coords * vs + vs / 2).astype(np.float32)
    inc = vs * 0.5
    steps = PL.default_max_steps(W, H, intr[0], intr[1], DEPTH_MIN, DEPTH_MAX, inc)
    sums = torch.zeros((num_ids, CHANNELS))
    counts = torch.zeros((num_ids,), dtype=torch.int32)
    for i in range(len(views)):
        hits = PL.first_hit_voxels(_t(occ), _t(views[i]), _t(intr), _t(origin),
                                   torch.tensor(vs, dtype=torch.float32), DEPTH_MIN,
                                   DEPTH_MAX, torch.tensor(inc, dtype=torch.float32), W, H,
                                   steps)
        s, c = PL.scatter_features(_t(feats[i]), hits, num_ids)
        sums, counts = sums + s, counts + c
    counts, sums = counts.numpy(), sums.numpy()
    nzm = counts[1:] > 0
    mean = np.zeros_like(sums[1:])
    mean[nzm] = sums[1:][nzm] / counts[1:][nzm, None]
    vox_pt = str(tmp_path / "voxel_features.pt")
    save_voxel_features(vox_pt, xyz=centers[nzm], avg_feats=mean[nzm],
                        voxel_coords=coords[nzm][:, ::-1])
    heat = np.clip(counts[1:] / max(counts.max(), 1), 0, 1)
    cols = np.stack([255 * heat, 64 + 0 * heat, 255 * (1 - heat)], axis=1).astype(np.uint8)
    grid_ply = str(tmp_path / "grid.ply")
    write_voxel_grid_ply(grid_ply, centers, cols, float(vs), origin,
                         grid_shape=occ.shape[::-1])
    reports = (compare_voxel_features(vox_pt, os.path.join(GOLD_DIR,
                                                           "golden_voxel_features.pt"))
               + compare_voxel_grids(grid_ply, os.path.join(GOLD_DIR, "golden_grid.ply")))
    assert reports and all(r.ok for r in reports), [r.line() for r in reports]
