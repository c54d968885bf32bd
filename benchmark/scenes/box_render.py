"""A render scene drawn from the seed: the draw of ``bench.py:80-102`` (as
``segsplat_tpu_torch/bench.py:headline_render_scene`` and
``perf_raster_stages.make_scene`` keep it), with its distributions:

  * means uniform in the box [-2, 2] × [-1.5, 1.5] × [2, 6] m in front of the
    camera;
  * scales log-normal, log N(-4.6, 0.3) a axis;
  * rotations: normal quaternions (normalised where they are used);
  * opacities U(0.3, 0.95), held as logits;
  * per-Gaussian logits N(0, 1), ``channels`` wide.

Drawn on the device with a ``torch.Generator`` seeded by ``--seed``, in a
few large calls, so bench.py's numpy bits are not kept: the seed picks the
scene.
"""

from __future__ import annotations

import torch


def draw(config: dict, seed: int, device) -> dict:
    """Table fields of ``config["gaussians"]`` Gaussians: xyz [N, 3],
    log_scales [N, 3], quats [N, 4], opacity_logit [N, 1] and logits
    [N, channels], float32 on ``device``."""
    n, ch = int(config["gaussians"]), int(config["channels"])
    g = torch.Generator(device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    lo = torch.tensor([-2.0, -1.5, 2.0], device=device)
    size = torch.tensor([4.0, 3.0, 4.0], device=device)
    xyz = torch.rand((n, 3), **f32) * size + lo
    log_scales = torch.randn((n, 3), **f32) * 0.3 - 4.6
    quats = torch.randn((n, 4), **f32)
    opac = torch.rand((n,), **f32) * 0.65 + 0.3
    logits = torch.randn((n, ch), **f32)
    return {"xyz": xyz, "log_scales": log_scales, "quats": quats,
            "opacity_logit": torch.log(opac / (1 - opac))[:, None], "logits": logits}
