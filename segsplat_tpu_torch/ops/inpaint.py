"""2D hole filling by mask-aware push–pull and Jacobi diffusion (the
counterpart of segsplat_tpu/ops/inpaint.py), the in-framework stand-in for the
reference's vendored LaMa stage (lama/prepare_pseudo_label.py:1-25), which
fills the holes object removal leaves before the masked finetune.

  1. *Push*: a validity-weighted pyramid down to 1×1, each level
     ``resize(img·w)`` and ``resize(w)`` at half the size (floor, at least 1),
     so known pixels spread into holes an octave a level.
  2. *Pull*: back up, keeping each level's known estimate and filling its holes
     with the upsampled coarser estimate.
  3. *Diffusion*: ``smooth_iters`` Jacobi steps of the 4-neighbour Laplacian
     inside the hole, with edge-clamped shifts (a wrapping roll would bleed the
     opposite edge into holes at the frame's border).

Resizes are ``F.interpolate(bilinear, antialias=True)``: half-pixel centres and
a widened triangle filter when shrinking, as ``jax.image.resize``. Every op is
batched over the frames. Known pixels come back bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from segsplat_tpu_torch.utils.system import require_device


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[V, C, H, W] → [V, C, h, w], ``jax.image.resize(..., "bilinear")``."""
    if x.shape[3] == 1 and w == 1:
        # the antialiased bilinear of torch 2.x resizes a one-column image
        # wrongly (off by up to 0.8 against the exact filter) and a one-row
        # image rightly: resize the transpose
        return F.interpolate(x.transpose(2, 3), size=(w, h), mode="bilinear",
                             align_corners=False, antialias=True).transpose(2, 3)
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def _down(x: torch.Tensor) -> torch.Tensor:
    """Half size (floor, at least 1 on each axis)."""
    return _resize(x, max(x.shape[2] // 2, 1), max(x.shape[3] // 2, 1))


def _pushpull(img: torch.Tensor, hole: torch.Tensor, smooth_iters: int) -> torch.Tensor:
    """img [V, C, H, W] float32, hole [V, 1, H, W] bool → filled [V, C, H, W]."""
    w = (~hole).to(torch.float32)
    pyr = [(img * w, w)]
    while max(pyr[-1][0].shape[2:]) > 1:
        iw, ww = pyr[-1]
        pyr.append((_down(iw), _down(ww)))

    iw, ww = pyr[-1]
    est = iw / torch.clamp_min(ww, 1e-8)
    for iw, ww in reversed(pyr[:-1]):
        up = _resize(est, *iw.shape[2:])
        est = torch.where(ww > 1e-8, iw / torch.clamp_min(ww, 1e-8), up)

    x = torch.where(w > 0, img, est)
    for _ in range(smooth_iters):
        up_ = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
        dn = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
        lf = torch.cat([x[..., :1], x[..., :-1]], dim=3)
        rt = torch.cat([x[..., 1:], x[..., -1:]], dim=3)
        x = torch.where(hole, (up_ + dn + lf + rt) * 0.25, x)
    return torch.where(hole, x, img)


def inpaint_frames(images, masks, smooth_iters: int = 64,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Fill the holes of a batch of frames on ``device``: images [V, H, W, C]
    float, masks [V, H, W] bool (True = fill), numpy or tensors. Returns
    [V, H, W, C] float32 on ``device``; known pixels are bit-identical."""
    device = require_device(device)
    img = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                          device=device).to(torch.float32).permute(0, 3, 1, 2)
    hole = torch.as_tensor(np.asarray(masks) if not torch.is_tensor(masks) else masks,
                           device=device).to(torch.bool)[:, None]
    return _pushpull(img, hole, smooth_iters).permute(0, 2, 3, 1).contiguous()


def inpaint_pushpull(image, hole, smooth_iters: int = 64,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Fill ``hole`` of one frame: image [H, W, C], hole [H, W] bool. Returns
    [H, W, C] float32 on ``device``, known pixels bit-identical."""
    image = image if torch.is_tensor(image) else np.asarray(image)
    hole = hole if torch.is_tensor(hole) else np.asarray(hole)
    return inpaint_frames(image[None], hole[None], smooth_iters, device=device)[0]
