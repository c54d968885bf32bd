"""The other grid builders of the port (segsplat_tpu_torch/pipeline/hash_grid.py
and surface_detection.py, host numpy and scipy as in the JAX package) against
the JAX package's on the seeded clouds of tests/test_aux_components.py: every
output exact."""

import numpy as np
import pytest

from segsplat_tpu.pipeline import hash_grid as JH
from segsplat_tpu.pipeline import surface_detection as JS
from segsplat_tpu_torch.pipeline import hash_grid as PH
from segsplat_tpu_torch.pipeline import surface_detection as PS


def _mixed_cloud(rng):
    """A dense cluster inside a sparse spread, with normals."""
    pts = np.concatenate([rng.random((300, 3)) * 4.0, 1.0 + rng.random((300, 3)) * 0.15])
    normals = rng.normal(size=pts.shape)
    return pts, normals / np.linalg.norm(normals, axis=1, keepdims=True)


def test_point_statistics_match_jax():
    rng = np.random.default_rng(0)
    pts, normals = _mixed_cloud(rng)
    cells = rng.integers(-50, 50, (100, 3))
    np.testing.assert_array_equal(PH.hash_cell_coords(cells), JH.hash_cell_coords(cells))
    for a, b in zip(PH.knn_stats(pts), JH.knn_stats(pts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PH.local_density(pts, 0.3), JH.local_density(pts, 0.3))
    for n in (normals, None):
        np.testing.assert_array_equal(PH.local_curvature(pts, n), JH.local_curvature(pts, n))


@pytest.mark.parametrize("kw", [dict(max_cell_size=0.5, max_points_per_cell=32, max_depth=4),
                                dict(max_cell_size=0.5, max_points_per_cell=1024,
                                     filter_below_average=True)])
def test_adaptive_hash_grid_matches_jax(kw):
    rng = np.random.default_rng(1)
    pts, normals = _mixed_cloud(rng)
    got = PH.AdaptiveHashGrid(**kw).build(pts, normals)
    ref = JH.AdaptiveHashGrid(**kw).build(pts, normals)
    for f in ("cell_sizes", "cell_coords", "cell_levels", "pruned"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert sorted(got._buckets) == sorted(ref._buckets)
    for k in ref._buckets:
        np.testing.assert_array_equal(got._buckets[k], ref._buckets[k])
    assert got.nested_cell_conflicts() == ref.nested_cell_conflicts() == 0
    q = pts[::40] + 0.003
    for a, b in zip(got.query_knn(q, k=3), ref.query_knn(q, k=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.build_structured_grid(0.5), ref.build_structured_grid(0.5)):
        np.testing.assert_array_equal(a, b)


def test_nested_cell_resolution_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([0.05 + 0.01 * rng.random((10, 3)), rng.random((3, 3)) * 0.9])
    coords = np.zeros((13, 3), np.int64)
    levels = np.array([2] * 10 + [0] * 3, np.int32)
    kw = dict(max_cell_size=1.0, max_points_per_cell=64, max_depth=4)
    got = PH.AdaptiveHashGrid(**kw)._resolve_nested_cells(pts, coords.copy(), levels.copy())
    ref = JH.AdaptiveHashGrid(**kw)._resolve_nested_cells(pts, coords.copy(), levels.copy())
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_minkowski_facade_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.random((200, 3)) * 2
    feats = rng.random((200, 4)).astype(np.float32)
    got, ref = PH.MinkowskiVoxelGrid(pts, feats, 0.5), JH.MinkowskiVoxelGrid(pts, feats, 0.5)
    for f in ("coordinates", "features", "inverse"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(got.get_voxel_centers(), ref.get_voxel_centers())
    assert got.grid_shape == ref.grid_shape
    np.testing.assert_array_equal(got.grid_origin, ref.grid_origin)


def test_surface_detector_matches_jax():
    rng = np.random.default_rng(4)
    plane = np.stack([rng.random(400) * 2, rng.random(400) * 2,
                      rng.normal(0, 0.005, 400)], axis=1)
    noise = rng.random((40, 3)) * 2 + np.array([0, 0, 0.5])
    xyz = np.concatenate([plane, noise])
    opacity = np.concatenate([np.full(400, 3.0), np.full(40, -3.0)])
    scales = np.log(rng.uniform(0.01, 0.08, (440, 3)))
    kw = dict(opacity_threshold=0.7, max_scale=0.06, dbscan_eps=0.2, dbscan_min_samples=5)
    for s in (None, scales):
        got = PS.SurfaceDetector(**kw).extract_surface(xyz, opacity, scales=s)
        ref = JS.SurfaceDetector(**kw).extract_surface(xyz, opacity, scales=s)
        assert sorted(got) == sorted(ref) and got["mask"].sum() > 100
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
