"""Plain PyTorch reference of stage 5's per-view products: a view's logits
of the real prompts, their argmax and the top1 − top2 softmax confidence,
from the scene's inputs. It imports nothing of the program.

The render is ``reference/raster.py``'s (projection, binning with the
per-axis tile cap m and the per-tile cap K, the front-to-back blend of 16×16
tiles, float32, TF32 off), on the P real channels alone: a channel's blend
reads no other channel, so the program's zero pad to 32 channels changes
none of them. The blend runs 256 tiles at a time (``raster.blend``), so a
876×584 view with ~4 M pairs fits.

Departures from the reference system's render (gsplat's rasterization in
``voxel_to_gaussian/render_semantics_logits.py``): the caps m and K are the
port's stated semantics, which gsplat does not have; like gsplat, no pair
cap truncates the view. The argmax is ``torch.argmax`` (the program's is
NumPy's; the check judges a label by its logit, so a tie taken either way
passes); the confidence is computed in float64 as the program's
``confidence_from_logits`` states it, in torch ops.

``view_work`` counts what a view needs for ``render_mfu.render``: the
blend's rows and passing pair-pixels, the pairs and tiles
(``raster.blend``'s counts), the Gaussians, the pixels and the channels.
"""

from __future__ import annotations

import torch

from benchmark.reference import raster


def gaussians(xyz, log_scales, quats, opacity_logit):
    """The table's activated fields: (means, scales, unit quaternions,
    opacities [N])."""
    q = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    return xyz, torch.exp(log_scales), q, torch.sigmoid(opacity_logit)[:, 0]


def view_logits(g, logits, cam: raster.Cam, m: int, K: int, bg_value: float = 0.0,
                blend_dtype=torch.float32) -> torch.Tensor:
    """The view's logits [P, H, W], float32 (``blend_dtype`` computes the
    blend's weights, colours and sums in another precision)."""
    raster.no_tf32()
    bg = torch.full((logits.shape[1],), bg_value, dtype=torch.float32, device=logits.device)
    with torch.no_grad():
        img = raster.render(*g, logits, bg, cam, m, K, blend_dtype=blend_dtype)
    return img.permute(2, 0, 1).contiguous()


def labels(view: torch.Tensor) -> torch.Tensor:
    """The argmax over the channels of [P, H, W] logits."""
    return view.argmax(0)


def confidence(view: torch.Tensor) -> torch.Tensor:
    """The top1 − top2 softmax probability margin [H, W] of [P, H, W]
    logits, in float64: the logits less their maximum, exponentiated,
    normalised; 1 where P is 1."""
    x = view.double()
    if x.shape[0] == 1:
        return torch.ones(x.shape[1:], dtype=torch.float64, device=x.device)
    p = torch.exp(x - x.max(0, keepdim=True).values)
    p = p / p.sum(0, keepdim=True)
    top = torch.topk(p, 2, dim=0).values
    return top[0] - top[1]


def view_work(g, logits, cam: raster.Cam, m: int, K: int) -> dict:
    """The view's counts (module docstring)."""
    raster.no_tf32()
    bg = torch.zeros(logits.shape[1], device=logits.device)
    w = {}
    with torch.no_grad():
        raster.render(*g, logits, bg, cam, m, K, work=w, image=False)
    w.update(channels=logits.shape[1], gaussians=g[0].shape[0],
             pixels=cam.width * cam.height)
    return w
