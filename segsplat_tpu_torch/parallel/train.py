"""Unified-Lift training on several views a step over a (view, tensor) mesh
(the counterpart of segsplat_tpu/parallel/train.py).

  * The view batch splits over the ``view`` ranks. Every rank holds the
    whole batch of B views and renders its B/n_view of them; the loss is
    Σ_{own views} total_v / B. One backward, then one ``all_reduce`` over the
    view ranks sums every parameter's gradient, the codebook's and the
    screen-offset gradient. Every rank then takes one step of both
    optimizers from the same state, so the replicas stay bit-equal.
  * The 256-row codebook logits ``code_book @ objects`` split over the
    ``tensor`` ranks (``compute_losses(shard_logits=...)``): a rank computes
    its 256/n_tensor rows and gathers the rest. The gather's backward keeps
    this rank's rows (``_GatherRows``): the incoming gradient is the same on
    every tensor rank, so ``torch.distributed.nn``'s gather, whose backward
    sums it over the group, would give n_tensor times the true gradient. The
    codebook's gradient is then complete only on the rows a rank owns (its
    logits plus the replicated clustering term); those rows' gradients are
    gathered over the tensor ranks before the update.
  * The densify statistics as the JAX step forms them: the loss is a mean
    over the batch, so the summed offset gradient is (1/B)·Σ_v g_v, and
    grad_accum gains ‖(g·B)[:, :2]‖ where any view saw the Gaussian; denom
    the number of views that saw it; max_radii the largest radius of any view.
  * Metrics are the batch means; ``num_pairs`` and ``tile_overflow`` the
    largest of any view.

The Gaussian table, both optimizers' state and the codebook are whole on
every rank. A B-view step approximates B single-view iterations with a
B-times larger batch, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from segsplat_tpu_torch.core.types import Camera
from segsplat_tpu_torch.parallel.mesh import (TENSOR_AXIS, VIEW_AXIS, Mesh, replicate,
                                              shard_range)
from segsplat_tpu_torch.train import trainer as T
from segsplat_tpu_torch.train.densify import PARAM_FIELDS, DensifyStats
from segsplat_tpu_torch.train.losses import CONTRAST_SAMPLES

MEAN_KEYS = ("l1", "dssim", "contrastive", "cls", "clustering", "reg", "total", "psnr")
MAX_KEYS = ("num_pairs", "tile_overflow")


class _GatherRows(torch.autograd.Function):
    """The tensor ranks' row blocks stacked in rank order; the backward keeps
    this rank's block of the (tensor-replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, mesh: Mesh, lo: int, hi: int):
        ctx.lo, ctx.hi = lo, hi
        return mesh.all_gather(local, TENSOR_AXIS, dim=0)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.hi], None, None, None


def _flat_all_reduce(mesh: Mesh, tensors, op) -> None:
    """Reduce ``tensors`` over the view ranks in place, as one flat buffer."""
    if mesh.groups is None:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.all_reduce(flat, VIEW_AXIS, op=op)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_parallel_train_step(cfg: T.OptimizationConfig, mesh: Mesh,
                             raster_kw: Optional[dict] = None):
    """The B-view train step: ``step(state, cameras, gt_images [B][3,H,W],
    gt_objs [B][H,W], bg [3], generator=None, idx=None) → metrics`` (0-dim
    tensors). ``cameras`` is a camera batch (``core/types.stack_cameras``);
    every rank passes the whole batch (tensors with a leading view axis, or
    sequences of per-view tensors on any device: a rank moves only its own
    views to the table's device), B a multiple of the view axis.
    ``idx`` [B, S] holds each view's contrastive sample, else all B are drawn
    from ``generator``, the same draws on every rank. It updates ``state`` in
    place, on every rank alike."""
    raster_kw = dict(raster_kw or {})
    if T.NUM_CODEBOOK % mesh.n_tensor:
        raise ValueError(f"tensor={mesh.n_tensor} does not divide the {T.NUM_CODEBOOK} "
                         "codebook rows")
    rows = shard_range(T.NUM_CODEBOOK, mesh.n_tensor, mesh.tensor_index)
    shard_logits = None
    if mesh.n_tensor > 1:
        def shard_logits(code_book, feats):
            return _GatherRows.apply(code_book[rows[0]:rows[1]] @ feats, mesh, *rows)

    def train_step(state: T.TrainState, cameras: Camera, gt_images, gt_objs,
                   bg: torch.Tensor, generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None) -> dict:
        B = len(gt_images)
        if B % mesh.n_view:
            raise ValueError(f"view batch {B} does not split over view={mesh.n_view}")
        table = state.table
        dev = table.xyz.device
        if idx is None:
            idx = torch.randint(0, gt_images[0].shape[-2] * gt_images[0].shape[-1],
                                (B, CONTRAST_SAMPLES), generator=generator, device=dev)
        lo, hi = shard_range(B, mesh.n_view, mesh.view_index)
        offset = torch.zeros((table.capacity, 2), dtype=torch.float32, device=dev,
                             requires_grad=True)
        state.gauss_opt.zero_grad(set_to_none=True)
        state.cls_opt.zero_grad(set_to_none=True)
        loss = 0.0
        sums = torch.zeros(len(MEAN_KEYS), dtype=torch.float32, device=dev)
        maxes = torch.zeros(len(MAX_KEYS), dtype=torch.float64, device=dev)
        vis_count = torch.zeros(table.capacity, dtype=torch.float32, device=dev)
        radii = torch.zeros(table.capacity, dtype=torch.float32, device=dev)
        for v in range(lo, hi):
            total, aux = T.compute_losses(table, state.code_book, cameras[v],
                                          gt_images[v].to(dev), gt_objs[v].to(dev), bg,
                                          cfg, offset, raster_kw, idx=idx[v].to(dev),
                                          shard_logits=shard_logits)
            loss = loss + total
            with torch.no_grad():
                sums += torch.stack([aux[k].detach() for k in MEAN_KEYS])
                maxes = torch.maximum(maxes, torch.stack([aux[k].double() for k in MAX_KEYS]))
                vis_count += aux["visible"].to(torch.float32)
                radii = torch.maximum(radii, aux["radii"].detach())
        (loss / B).backward()

        with torch.no_grad():
            cb = state.code_book
            if mesh.n_tensor > 1:
                cb.grad = mesh.all_gather(cb.grad[rows[0]:rows[1]], TENSOR_AXIS, dim=0)
            grads = [g for g in (getattr(table, f).grad for f in PARAM_FIELDS)
                     if g is not None]
            _flat_all_reduce(mesh, grads + [cb.grad, offset.grad, vis_count, sums],
                             dist.ReduceOp.SUM)
            radii64 = radii.double()
            _flat_all_reduce(mesh, [radii64, maxes], dist.ReduceOp.MAX)
            radii = radii64.float()
        T.apply_updates(state)

        with torch.no_grad():
            visible = (vis_count > 0).to(torch.float32)
            g = torch.linalg.norm((offset.grad * B)[:, :2], dim=-1)
            st = state.stats
            state.stats = DensifyStats(grad_accum=st.grad_accum + g * visible,
                                       denom=st.denom + vis_count,
                                       max_radii=torch.maximum(st.max_radii, radii * visible))
        state.step += 1
        metrics = dict(zip(MEAN_KEYS, sums / B))
        metrics.update(zip(MAX_KEYS, maxes.to(torch.int64)))
        return metrics

    return train_step


def replicate_state(state: T.TrainState, mesh: Mesh) -> T.TrainState:
    """Broadcast the table, its active rows, the codebook and the densify
    statistics from world rank 0 (the optimizers' state is broadcast with a
    resumed checkpoint: ``pipeline/train.load_checkpoint``)."""
    t = state.table
    replicate([getattr(t, f) for f in PARAM_FIELDS] + [t.active, state.code_book]
              + list(state.stats), mesh)
    return state
