"""The camera path generator every mix uses: a yaw that oscillates about the
start pose, drawn from the seed.

    yaw_i = amplitude · sin(2π·i / period + phase) + jitter_i

``phase`` is uniform in [0, 2π) and each ``jitter_i`` uniform in
±``jitter``, both from the seed, so two seeds give the same set of poses in
another order and no two frames of one path share a pose. The rotation is
about the camera's y axis, as the bench's cameras turn.
"""

from __future__ import annotations

import numpy as np
import torch


def yaws(params: dict, seed: int, n: int) -> np.ndarray:
    """The first ``n`` yaws (float64) of the path ``params`` (amplitude_rad,
    period, jitter_rad) for ``seed``."""
    rng = np.random.default_rng([seed % 2 ** 64, 0x5EED])
    phase = rng.uniform(0.0, 2 * np.pi)
    jitter = rng.uniform(-params["jitter_rad"], params["jitter_rad"], n)
    i = np.arange(n, dtype=np.float64)
    return params["amplitude_rad"] * np.sin(2 * np.pi * i / params["period"] + phase) + jitter


def rotations(params: dict, seed: int, n: int, device) -> torch.Tensor:
    """[n, 3, 3] float32 camera-to-world rotations of the path, on ``device``."""
    a = yaws(params, seed, n)
    c, s = np.cos(a), np.sin(a)
    R = np.zeros((n, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = c, s, 1.0, -s, c
    return torch.as_tensor(R, device=device)
