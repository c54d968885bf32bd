"""The port's kNN mean squared distance (segsplat_tpu_torch/ops/knn.py) against
the JAX package's, on the distributions of tests/test_knn.py, at 1e-5
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.ops import knn as K
from segsplat_tpu_torch.ops import knn as P


def _points(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "normal":
        return rng.normal(size=(400, 3)).astype(np.float32)
    if kind == "clustered":
        centers = rng.normal(size=(8, 3)) * 10
        return (centers[rng.integers(0, 8, 600)]
                + rng.normal(size=(600, 3)) * 0.1).astype(np.float32)
    # a point cloud with exact Morton ties: a coarse lattice, many points per cell
    return (rng.integers(0, 6, (1500, 3)) + rng.normal(size=(1500, 3)) * 1e-4
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "clustered", "lattice"])
def test_knn_mean_sq_dist_matches_jax(kind):
    pts = _points(kind)
    ref = np.asarray(K.knn_mean_sq_dist(jnp.asarray(pts), k=3))
    got = P.knn_mean_sq_dist(torch.from_numpy(pts), k=3).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


def test_morton_codes_match_jax_and_sort_stably():
    pts = _points("lattice")
    ref = np.asarray(K.morton_codes(jnp.asarray(pts))).astype(np.int64)
    got = P.morton_codes(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) < len(got), "the lattice must have tied codes"
    np.testing.assert_array_equal(torch.sort(torch.from_numpy(got), stable=True).indices,
                                  np.asarray(jnp.argsort(jnp.asarray(ref))))


def test_initial_log_scales_matches_jax():
    pts = _points("normal")[:100]
    ref = np.asarray(K.initial_log_scales(pts))
    got = P.initial_log_scales(pts, device="cpu").numpy()
    assert got.shape == (100, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
