"""Linear sum assignment (Jonker–Volgenant shortest augmenting paths) on the
host, in numpy float32.

The counterpart of segsplat_tpu/ops/assignment.py, whose solver runs on the
TPU inside the train step's XLA program. The algorithm is sequential per row;
as torch ops on the card it would launch thousands of tiny kernels per step,
so the port solves the fetched [256, 256] cost here: one host sync per step,
as in the reference (train_unified_lift.py:258-260). The arithmetic, the tie
rule (argmin takes the first index) and the ``row_mask`` skipping are the JAX
solver's, so both give the same columns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def linear_sum_assignment(cost: np.ndarray, row_mask: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost matching on a square [N, N] cost. ``row_mask`` [N] bool
    restricts it to a subset of rows; masked rows get column -1.

    Returns (col_of_row [N] int32, row_of_col [N] int32)."""
    cost = np.asarray(cost, np.float32)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"cost must be square, got {cost.shape}")
    row_mask = np.ones(n, bool) if row_mask is None else np.asarray(row_mask, bool)
    v = np.zeros(n, np.float32)
    row_of_col = np.full(n, -1, np.int32)
    col_of_row = np.full(n, -1, np.int32)
    inf = np.float32(np.inf)

    for i in np.flatnonzero(row_mask):
        # grow an alternating tree from row i until a free column is reached
        d = cost[i] - v
        pred = np.full(n, i, np.int32)
        scanned = np.zeros(n, bool)
        while True:
            j = int(np.argmin(np.where(scanned, inf, d)))
            r = int(row_of_col[j])
            if r < 0:
                j_free, delta = j, d[j]
                break
            slack = d[j] + (cost[r] - v) - (cost[r, j] - v[j])
            upd = ~scanned & (slack < d)
            upd[j] = False
            d = np.where(upd, slack, d)
            pred = np.where(upd, np.int32(r), pred)
            scanned[j] = True
        # dual update over scanned columns
        v = np.where(scanned, v + d - delta, v)
        # augment: flip matched edges along the pred chain back to row i
        j = j_free
        while j >= 0:
            r = int(pred[j])
            row_of_col[j] = r
            j_next = int(col_of_row[r])
            col_of_row[r] = j
            j = -1 if r == i else j_next
    return col_of_row, row_of_col
