"""Adaptive density control on a fixed-capacity table (the counterpart of
segsplat_tpu/train/densify.py, after the reference's
scene/gaussian_model.py:469-608).

The table keeps its capacity and ``active`` mask, as in the JAX package:
pruning clears ``active``; clone and split children go into the lowest free
rows, ranked by a cumulative sum; the Adam moments of changed rows are zeroed
by mask. Unlike the JAX package, the parameter tensors are updated in place
(under ``torch.no_grad``), so the optimizers keep referring to them; every
gather is taken before the first write, so the result equals the functional
one.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Tuple

import torch

from segsplat_tpu_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from segsplat_tpu_torch.core.types import GaussianTable

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "objects_dc")


class DensifyStats(NamedTuple):
    """xyz_gradient_accum / denom / max_radii2D of the reference."""
    grad_accum: torch.Tensor   # [C]
    denom: torch.Tensor        # [C]
    max_radii: torch.Tensor    # [C]

    @staticmethod
    def zero(capacity: int, device="cpu") -> "DensifyStats":
        z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
        return DensifyStats(z(), z(), z())


@torch.no_grad()
def add_stats(stats: DensifyStats, means2d_grad: torch.Tensor, visible: torch.Tensor,
              radii: torch.Tensor) -> DensifyStats:
    """Accumulate screen-space mean gradient norms of visible Gaussians. No
    autograd: the statistics must not keep a step's graph alive."""
    g = torch.linalg.norm(means2d_grad[:, :2], dim=-1)
    vis = visible.to(torch.float32)
    return DensifyStats(grad_accum=stats.grad_accum + g * vis,
                        denom=stats.denom + vis,
                        max_radii=torch.maximum(stats.max_radii, radii * vis))


@torch.no_grad()
def densify_and_prune(table: GaussianTable, stats: DensifyStats, grad_threshold: float,
                      min_opacity: float, scene_extent: float,
                      percent_dense: float = 0.01, max_screen_size: float = 20.0,
                      max_screen_size_on: bool = False,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[GaussianTable, DensifyStats, torch.Tensor, torch.Tensor]:
    """One clone + split + prune step, in place on the table's tensors.

    ``noise`` [2C, 3] standard normal draws for the split offsets (drawn from
    ``generator`` when not given). Returns (table with the new ``active``,
    fresh stats, changed rows [C] bool whose Adam moments must be zeroed,
    overflow: children dropped because the table is full, a 0-dim tensor)."""
    C = table.capacity
    dev = table.xyz.device
    grads = torch.where(stats.denom > 0,
                        stats.grad_accum / torch.clamp_min(stats.denom, 1), 0.0)
    scal = table.get_scaling()
    max_scale = scal.amax(dim=1)
    opac = table.get_opacity()[:, 0]
    act = table.active

    hot = act & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * scene_extent)
    split_mask = hot & (max_scale > percent_dense * scene_extent)
    prune = act & (opac < min_opacity)
    if max_screen_size_on:
        prune = prune | (act & (stats.max_radii > max_screen_size)) \
                      | (act & (max_scale > 0.1 * scene_extent))
    # split parents are pruned after spawning children
    active_after = act & ~prune & ~split_mask

    # candidate children [3C]: clone child | split child A | split child B
    child_valid = torch.cat([clone_mask, split_mask, split_mask])
    src = torch.arange(C, device=dev).repeat(3)
    # free rows after pruning, lowest index first (a stable sort, as jnp.argsort)
    free = ~active_after
    free_order = torch.sort((~free).to(torch.uint8), stable=True).indices
    n_free = free.sum()
    rank = torch.cumsum(child_valid.to(torch.int64), 0) - 1
    fits = child_valid & (rank < n_free)
    slots = free_order[torch.clamp(rank, 0, C - 1)][fits]
    overflow = (child_valid & ~fits).sum()

    # split children: offset ~ N(0, scale) rotated; scale / 1.6
    if noise is None:
        noise = torch.randn((2 * C, 3), generator=generator, device=dev)
    offsets = torch.einsum("nij,nj->ni", quat_to_rotmat(table.rotation.repeat(2, 1)),
                           noise * scal.repeat(2, 1))
    child = {name: getattr(table, name)[src] for name in PARAM_FIELDS}
    child["xyz"] = torch.cat([table.xyz, table.xyz.repeat(2, 1) + offsets])
    child["scaling"] = torch.cat([table.scaling,
                                  torch.log(torch.clamp_min(scal.repeat(2, 1) / 1.6, 1e-12))])
    for name in PARAM_FIELDS:                       # every gather is done: write
        getattr(table, name)[slots] = child[name][fits]
    new_active = active_after.clone()
    new_active[slots] = True
    changed = prune | split_mask
    changed[slots] = True
    return (dataclasses.replace(table, active=new_active), DensifyStats.zero(C, dev),
            changed, overflow)


@torch.no_grad()
def reset_opacity(table: GaussianTable) -> Tuple[GaussianTable, torch.Tensor]:
    """Clamp every opacity to ≤ 0.01, in place. Returns (table, changed rows)."""
    table.opacity.copy_(inverse_sigmoid(torch.clamp_max(table.get_opacity(), 0.01)))
    return table, table.active


@torch.no_grad()
def zero_adam_rows(optimizer: torch.optim.Optimizer, changed: torch.Tensor,
                   fields: Optional[Iterable[str]] = None) -> None:
    """Zero the first and second Adam moments of the changed rows, in place —
    the mask form of the reference's optimizer-state surgery. ``fields``
    limits it to the parameter groups of those names: the opacity reset zeroes
    only the opacity group's moments."""
    fields = set(fields) if fields is not None else None
    for group in optimizer.param_groups:
        if fields is not None and group["name"] not in fields:
            continue
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:        # no moments before the first step
                    state[key][changed] = 0.0


def grow_capacity(table: GaussianTable, stats: DensifyStats,
                  new_capacity: int) -> Tuple[GaussianTable, DensifyStats]:
    """A table and stats padded to ``new_capacity`` rows (inactive, identity
    rotation). The padded tensors are new: optimizers built on the old ones
    must be rebuilt."""
    extra = new_capacity - table.capacity
    if extra <= 0:
        raise ValueError(f"new capacity {new_capacity} ≤ capacity {table.capacity}")
    pad = lambda x: torch.cat([x.detach(), x.new_zeros((extra,) + x.shape[1:])])
    rot = torch.cat([table.rotation.detach(), table.rotation.new_zeros((extra, 4))])
    rot[table.capacity:, 0] = 1.0
    fields = {name: pad(getattr(table, name)) for name in PARAM_FIELDS}
    fields["rotation"] = rot
    t = dataclasses.replace(table, **fields, active=pad(table.active))
    return t, DensifyStats(*(pad(x) for x in stats))
