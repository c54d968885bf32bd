"""The port's host LAP solver (segsplat_tpu_torch/ops/assignment.py) against the
JAX package's on-device Jonker–Volgenant solver: the same columns on tie-free
random costs, with and without ``row_mask``, and the same total cost as
scipy.optimize.linear_sum_assignment."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lap

from segsplat_tpu.ops.assignment import linear_sum_assignment as jax_lap
from segsplat_tpu_torch.ops.assignment import linear_sum_assignment


@pytest.mark.parametrize("n,masked", [(1, False), (5, False), (64, False), (256, False),
                                      (64, True), (256, True)])
def test_assignment_matches_jax_solver(n, masked):
    rng = np.random.default_rng(n + masked)
    cost = rng.random((n, n)).astype(np.float32)          # continuous: no ties
    if n == 256:
        cost = -cost                                       # the training cost's sign
    mask = rng.random(n) < 0.3 if masked else None
    if masked:
        mask[0] = True
    got_col, got_row = linear_sum_assignment(cost, row_mask=mask)
    ref_col, ref_row = jax_lap(jnp.asarray(cost),
                               row_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got_col, np.asarray(ref_col))
    np.testing.assert_array_equal(got_row, np.asarray(ref_row))

    rows = np.flatnonzero(mask) if masked else np.arange(n)
    assert (got_col[np.setdiff1d(np.arange(n), rows)] == -1).all()
    ri, ci = scipy_lap(cost[rows])
    np.testing.assert_allclose(cost[rows, got_col[rows]].sum(), cost[rows][ri, ci].sum(),
                               rtol=1e-5, atol=1e-5)


def test_assignment_rejects_a_non_square_cost():
    with pytest.raises(ValueError, match="square"):
        linear_sum_assignment(np.zeros((3, 4), np.float32))
