"""Rendering front-end on the port's rasterizer (the counterpart of
segsplat_tpu/render.py):

  * ``render``: RGB from SH plus the 16 identity channels in one 19-channel
    pass, differentiable — what the trainer renders (the reference's
    gaussian_renderer/__init__.py:18-120); with ``semantic_logits`` also the
    32 logit channels, in one 51-channel pass;
  * ``render_semantics`` / ``render_semantics_many``: 32 logit channels, the
    gsplat call in the reference's FPS-metric loop
    (render_semantics_logits.py:92-105).

Each takes ``backend``: ``"cuda"`` (the JAX package's ``"pallas"``, the
kernels) or ``"dense"`` (its ``"xla"``), see ``ops/rasterize.rasterize``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from segsplat_tpu_torch.core.sh import eval_sh
from segsplat_tpu_torch.core.types import NUM_SEMANTIC_CHANNELS, Camera, GaussianTable
from segsplat_tpu_torch.ops.rasterize import BACKENDS, pad_logits_to_channels, rasterize

__all__ = ["BACKENDS", "raster_backend", "render", "render_semantics", "render_semantics_many", "sh_colors"]


def raster_backend(device) -> str:
    """The kernels on the card; the dense blend where the caller asks for the
    CPU (the JAX scripts' "xla")."""
    return "dense" if torch.device(device).type == "cpu" else "cuda"


def sh_colors(table: GaussianTable, campos: torch.Tensor) -> torch.Tensor:
    """View-dependent RGB [C, 3] from SH, with the coefficient bands above the
    table's active_sh_degree zeroed, as the JAX package does."""
    sh = table.get_features()                       # [C, K, 3]
    coeff_ids = torch.arange(sh.shape[1], device=sh.device)
    band = torch.floor(torch.sqrt(coeff_ids.float())).long()
    mask = (band <= table.active_sh_degree).to(sh.dtype)
    sh = sh * mask[None, :, None]
    dirs = table.xyz - campos
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return torch.clamp_min(eval_sh(table.max_sh_degree, sh, dirs) + 0.5, 0.0)


def render(table: GaussianTable, camera: Camera, bg_color: torch.Tensor,
           semantic_logits: Optional[torch.Tensor] = None,
           means2d_offset: Optional[torch.Tensor] = None,
           scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           max_tiles_per_axis: int = 8, max_per_tile: int = 512,
           tile_chunk: int = 64, backend: str = "cuda",
           pair_cap: Optional[int] = None) -> dict:
    """RGB + identity (+ semantic logits) in one differentiable rasterizer pass
    (segsplat_tpu/render.py:43-98).

    bg_color [3]; the identity and logit channels composite on 0.
    semantic_logits [C, P] per-Gaussian logits, padded or sliced to 32
    channels. override_color [C, 3] replaces the SH colours. Returns
    ``render`` [3, H, W], ``render_object`` [16, H, W], with semantic_logits
    also ``semantic_logits`` [32, H, W], and ``radii``, ``visibility_filter``,
    ``alpha``, ``depths``, ``num_pairs`` and ``tile_overflow``."""
    campos = camera.camera_center()
    K = camera.intrinsics()
    rgb = sh_colors(table, campos) if override_color is None else override_color
    identity = table.objects_dc[:, 0, :]                      # [C, 16]
    zeros = lambda n: torch.zeros((n,), dtype=rgb.dtype, device=rgb.device)
    payload = [rgb, identity]
    bg = [bg_color.to(rgb.dtype), zeros(identity.shape[1])]
    if semantic_logits is not None:
        payload.append(pad_logits_to_channels(semantic_logits, NUM_SEMANTIC_CHANNELS))
        bg.append(zeros(NUM_SEMANTIC_CHANNELS))
    opac = table.get_opacity()[:, 0] * table.active.to(rgb.dtype)
    out = rasterize(table.xyz, scaling_modifier * table.get_scaling(), table.get_rotation(),
                    opac, torch.cat(payload, dim=1),
                    camera.world_view_transform(), K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                    camera.width, camera.height,
                    bg=torch.cat(bg), means2d_offset=means2d_offset,
                    max_tiles_per_axis=max_tiles_per_axis, max_per_tile=max_per_tile,
                    tile_chunk=tile_chunk, backend=backend, pair_cap=pair_cap)
    img = out["image"]
    n_id = identity.shape[1]
    result = {
        "render": img[..., 0:3].permute(2, 0, 1),
        "render_object": img[..., 3:3 + n_id].permute(2, 0, 1),
        "radii": out["radii"],
        "visibility_filter": out["radii"] > 0,
        "alpha": out["alpha"],
        "depths": out["depths"],
        "num_pairs": out["num_pairs"],
        "tile_overflow": out["tile_overflow"],
    }
    if semantic_logits is not None:
        result["semantic_logits"] = img[..., 3 + n_id:].permute(2, 0, 1)
    return result


def _semantic_inputs(table: GaussianTable, logits: torch.Tensor, bg_value: float):
    """The view-independent rasterize arguments: activated table, payload, bg."""
    payload = pad_logits_to_channels(logits, NUM_SEMANTIC_CHANNELS)
    opac = table.get_opacity()[:, 0] * table.active.to(payload.dtype)
    bg = torch.full((NUM_SEMANTIC_CHANNELS,), bg_value, dtype=payload.dtype,
                    device=payload.device)
    return (table.xyz, table.get_scaling(), table.get_rotation(), opac, payload), bg


def _render_one(gaussians, bg, camera: Camera, **raster_kw):
    K = camera.intrinsics()
    return rasterize(*gaussians, camera.world_view_transform(),
                     K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                     camera.width, camera.height, bg=bg, **raster_kw)


def render_semantics(table: GaussianTable, camera: Camera, logits: torch.Tensor,
                     bg_value: float = 0.0, max_tiles_per_axis: int = 8,
                     max_per_tile: int = 512, backend: str = "cuda",
                     pair_cap: Optional[int] = None, return_aux: bool = False):
    """Semantic logits [32, H, W] of one view, on the table's device. With
    ``return_aux`` also a dict of 0-dim tensors ``num_pairs`` and
    ``tile_overflow``, so callers can surface truncation."""
    gaussians, bg = _semantic_inputs(table, logits, bg_value)
    out = _render_one(gaussians, bg, camera, max_tiles_per_axis=max_tiles_per_axis,
                      max_per_tile=max_per_tile, backend=backend, pair_cap=pair_cap)
    sem = out["image"].permute(2, 0, 1)
    if return_aux:
        return sem, {"tile_overflow": out["tile_overflow"], "num_pairs": out["num_pairs"]}
    return sem


def render_semantics_many(table: GaussianTable, cameras: Sequence[Camera],
                          logits: torch.Tensor, bg_value: float = 0.0,
                          max_tiles_per_axis: int = 8, max_per_tile: int = 512,
                          backend: str = "cuda", pair_cap: Optional[int] = None,
                          view_batch: int = 8):
    """View sweep. All cameras must share width/height.

    Views are enqueued ``view_batch`` at a time; the host waits once per batch,
    to read that batch's counters. Yields ``(view_index, sem [32,H,W] on the
    device, aux)`` per camera, where aux carries python-int ``tile_overflow``
    and ``num_pairs``."""
    W, H = cameras[0].width, cameras[0].height
    if not all(c.width == W and c.height == H for c in cameras):
        raise ValueError("render_semantics_many requires uniform resolution; "
                         "group cameras by (width, height) first")
    gaussians, bg = _semantic_inputs(table, logits, bg_value)
    raster_kw = dict(max_tiles_per_axis=max_tiles_per_axis, max_per_tile=max_per_tile,
                     backend=backend, pair_cap=pair_cap)
    B = max(1, view_batch)
    for start in range(0, len(cameras), B):
        outs = [_render_one(gaussians, bg, cam, **raster_kw)
                for cam in cameras[start:start + B]]
        counters = torch.stack([torch.stack([o["tile_overflow"], o["num_pairs"].long()])
                                for o in outs]).tolist()          # one host sync
        for j, (out, (ovf, npairs)) in enumerate(zip(outs, counters)):
            yield start + j, out["image"].permute(2, 0, 1), {
                "tile_overflow": int(ovf), "num_pairs": int(npairs)}
