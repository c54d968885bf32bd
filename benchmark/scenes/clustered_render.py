"""A clustered render scene, as a densified, trained 3D Gaussian Splatting
scene packs its Gaussians onto surfaces: the draw of ``bench.py:105-132``
(``segsplat_tpu_torch/bench.py:hostile_render_scene``), with its
distributions:

  * the layout, fixed by the configuration: ``clusters`` centres uniform in
    the box [-2, 2] × [-1.5, 1.5] × [2, 6] m in front of the camera, and
    their counts from Pareto(1.2) + 0.05 weights over ``gaussians`` (the
    remainder to cluster 0), drawn with NumPy from ``layout_seed`` exactly as
    bench.py draws them. The Pareto weights swing the largest cluster's
    share widely from one draw to the next, and the frame's rate with it, so
    a configuration is one layout, as a data set is one scene;
  * drawn from ``--seed``, on the device: offsets N(0, 0.08 m) a axis from
    the cluster's centre, scales log N(-4.3, 0.8) a axis, normal quaternions
    (normalised where they are used), opacities U(0.02, 0.9) held as logits,
    and per-Gaussian logits N(0, 1), ``channels`` wide.
"""

from __future__ import annotations

import numpy as np
import torch

BOX_LO = np.array([-2.0, -1.5, 2.0])
BOX_SIZE = np.array([4.0, 3.0, 4.0])


def layout(config: dict):
    """The clusters' centres [clusters, 3] (float64) and counts [clusters]
    (int64, summing to ``gaussians``), from ``layout_seed`` alone."""
    n, k = int(config["gaussians"]), int(config["clusters"])
    rng = np.random.default_rng(int(config["layout_seed"]))
    centres = rng.random((k, 3)) * BOX_SIZE + BOX_LO
    w = rng.pareto(1.2, k) + 0.05
    counts = np.maximum((w / w.sum() * n).astype(int), 1)
    counts[0] += n - counts.sum()
    return centres, counts.astype(np.int64)


def draw(config: dict, seed: int, device) -> dict:
    """Table fields of ``config["gaussians"]`` Gaussians: xyz [N, 3],
    log_scales [N, 3], quats [N, 4], opacity_logit [N, 1] and logits
    [N, channels], float32 on ``device``."""
    n, ch = int(config["gaussians"]), int(config["channels"])
    centres, counts = layout(config)
    assign = torch.repeat_interleave(torch.arange(len(counts), device=device),
                                     torch.as_tensor(counts, device=device))
    g = torch.Generator(device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    xyz = torch.as_tensor(centres, dtype=torch.float32, device=device)[assign]
    xyz = xyz + torch.randn((n, 3), **f32) * 0.08
    log_scales = torch.randn((n, 3), **f32) * 0.8 - 4.3
    quats = torch.randn((n, 4), **f32)
    opac = torch.rand((n,), **f32) * 0.88 + 0.02
    logits = torch.randn((n, ch), **f32)
    return {"xyz": xyz, "log_scales": log_scales, "quats": quats,
            "opacity_logit": torch.log(opac / (1 - opac))[:, None], "logits": logits}
