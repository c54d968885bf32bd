"""The officescene room that stage 5 renders: the production run's
fabricated scene (``segsplat_tpu_torch/officescene_scale_run.py``), as the
lift cell's ``scenes/room_lift.py`` keeps its geometry, with the table
``fabricate`` writes and per-Gaussian logits of the 13 prompts:

  * the centres, fixed by the configuration: ``room_points`` (imported from
    ``room_lift.py``) on NumPy's ``default_rng(layout_seed)``;
  * drawn from ``--seed``, on the device: log-scales N(log_scale_mean,
    log_scale_std), quaternions N(0, 1) (normalised where they are used),
    the opacity logit ``opacity_logit`` for every Gaussian (0.90 after the
    sigmoid), and logits [N, prompts], N(0, 1) plus ``logit_boost`` at the
    class ``part mod prompts`` of the Gaussian's part of the room
    (``parts``), piecewise constant over objects as the voxel-to-Gaussian
    transfer gives them;
  * the 216 orbit cameras of ``room_lift.cameras`` as render cameras at
    ``width`` × ``height``: the camera-to-world rotation R, the world-to-
    camera translation T, and the fields of view of the focal length
    ``fx_native`` · ``downsample`` about the image's centre.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.harness.cell import load_module

ROOM = load_module(Path(__file__).with_name("room_lift.py"))


def parts(n: int) -> np.ndarray:
    """The part of the room each of ``room_points``' ``n`` centres belongs
    to, in its order: the six shells (floor, ceiling, two side walls, back
    and front wall; 14, 14, 10, 10, 7 and 7 % of n) as parts 0-5, then the
    30 clutter blobs as parts 6-35, the last taking the remainder."""
    shells = [int(n * f) for f in (0.14, 0.14, 0.10, 0.10, 0.07, 0.07)]
    remaining = n - sum(shells)
    per = remaining // 30
    sizes = shells + [per] * 29 + [remaining - per * 29]
    return np.repeat(np.arange(len(sizes)), sizes)


def cameras(config: dict):
    """The orbit's render cameras: R [views, 3, 3] (camera-to-world), T
    [views, 3] (world-to-camera), float32 NumPy, and (fov_x, fov_y) in
    radians."""
    c2w, intr = ROOM.cameras(config)
    R = c2w[:, :3, :3].astype(np.float64)
    T = -np.einsum("vji,vj->vi", R, c2w[:, :3, 3].astype(np.float64))
    fx, fy = float(intr[0]), float(intr[1])
    fov_x = 2.0 * math.atan(config["width"] / (2.0 * fx))
    fov_y = 2.0 * math.atan(config["height"] / (2.0 * fy))
    return R.astype(np.float32), T.astype(np.float32), (fov_x, fov_y)


def draw(config: dict, seed: int, device) -> dict:
    """Table fields of the room's Gaussians: xyz [N, 3], log_scales [N, 3],
    quats [N, 4], opacity_logit [N, 1], logits [N, prompts], float32 on
    ``device``; ``parts`` [N] (NumPy); the cameras (``cameras``) as ``R``,
    ``T`` on ``device`` and ``fov``."""
    n, p = int(config["gaussians"]), int(config["prompts"])
    xyz = ROOM.room_points(np.random.default_rng(int(config["layout_seed"])), n)
    part = parts(n)
    g = torch.Generator(device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    log_scales = (torch.randn((n, 3), generator=g, **f32) * config["log_scale_std"]
                  + config["log_scale_mean"])
    quats = torch.randn((n, 4), generator=g, **f32)
    logits = torch.randn((n, p), generator=g, **f32)
    cls = torch.as_tensor(part % p, device=device)
    logits[torch.arange(n, device=device), cls] += config["logit_boost"]
    R, T, fov = cameras(config)
    return {"xyz": torch.as_tensor(xyz, **f32), "log_scales": log_scales, "quats": quats,
            "opacity_logit": torch.full((n, 1), config["opacity_logit"], **f32),
            "logits": logits, "parts": part, "R": torch.as_tensor(R, **f32),
            "T": torch.as_tensor(T, **f32), "fov": fov}
