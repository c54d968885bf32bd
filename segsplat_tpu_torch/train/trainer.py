"""Unified-Lift train step (the counterpart of segsplat_tpu/train/trainer.py,
after the reference's train_unified_lift.py:287-500).

One step renders one view (K1 forward, K2 backward), takes the photometric and
identity-feature losses (contrastive, confidence-gated cross-entropy against the
Hungarian virtual GT, codebook clustering, norm regularisation), and updates
two Adam optimizers: the table's, with one parameter group per field and the
exponential xyz schedule, and the codebook's. The JAX package compiles all of
it into one XLA program; here it runs eagerly, and the LAP is solved on the
host (one sync per step).

The table's parameter tensors are leaf tensors that the optimizers update in
place; densification (train/densify.py) writes into them in place too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from segsplat_tpu_torch.core.sh import rgb2sh
from segsplat_tpu_torch.core.transforms import get_expon_lr_func, inverse_sigmoid
from segsplat_tpu_torch.core.types import NUM_CODEBOOK, NUM_OBJECTS, Camera, GaussianTable
from segsplat_tpu_torch.ops.knn import knn_mean_sq_dist
from segsplat_tpu_torch.render import render
from segsplat_tpu_torch.train import losses as L
from segsplat_tpu_torch.train.densify import PARAM_FIELDS, DensifyStats, add_stats
from segsplat_tpu_torch.utils.profiling import annotate
from segsplat_tpu_torch.utils.system import require_device

# parameter group of each table field, as the JAX package labels them
GROUP_OF_FIELD = {"xyz": "xyz", "features_dc": "f_dc", "features_rest": "f_rest",
                  "opacity": "opacity", "scaling": "scaling", "rotation": "rotation",
                  "objects_dc": "obj_dc"}


@dataclasses.dataclass
class OptimizationConfig:
    """Hyperparameters; defaults are the reference's OptimizationParams."""
    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    codebook_lr: float = 5e-4
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    min_opacity: float = 0.005
    num_classes: int = 256
    # loss weights (train_unified_lift.py:416)
    w_contrastive: float = 1e-6
    w_cls: float = 1e-4
    w_clustering: float = 1.0
    w_reg: float = 1e-6


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates. ``step`` counts the updates taken; the
    xyz learning rate of update s is ``xyz_schedule(s)``."""
    table: GaussianTable
    gauss_opt: torch.optim.Adam
    code_book: torch.Tensor           # [256, 16] leaf tensor
    cls_opt: torch.optim.Adam
    stats: DensifyStats
    step: int
    xyz_schedule: Callable[[int], float]


def init_table_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                        max_sh_degree: int = 3, seed: int = 0,
                        device="cuda") -> GaussianTable:
    """The reference's create_from_pcd: SH-DC from RGB, random identity
    features (numpy ``default_rng(seed)``, as the JAX package draws them),
    scales from the 3-NN mean distance, opacity 0.1, on ``device``."""
    device = require_device(device)
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    r = (max_sh_degree + 1) ** 2 - 1
    d2 = knn_mean_sq_dist(torch.as_tensor(np.asarray(points, np.float32),
                                          device=device)).cpu().numpy()
    log_scale = np.log(np.sqrt(np.clip(d2, 1e-7, None)))
    rng = np.random.default_rng(seed)

    def place(shape, vals=None):
        out = np.zeros((capacity,) + shape, np.float32)
        if vals is not None:
            out[:n] = np.asarray(vals, np.float32).reshape((n,) + shape)
        return torch.from_numpy(out).to(device)

    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    op0 = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))
    return GaussianTable(
        xyz=place((3,), points),
        features_dc=place((1, 3), rgb2sh(np.asarray(colors, np.float32))),
        features_rest=place((r, 3)),
        scaling=place((3,), np.repeat(log_scale[:, None], 3, 1)),
        rotation=torch.from_numpy(rot).to(device),
        opacity=place((1,), np.full((n, 1), op0, np.float32)),
        objects_dc=place((1, NUM_OBJECTS), rgb2sh(rng.random((n, NUM_OBJECTS)))),
        active=torch.arange(capacity, device=device) < n,
        active_sh_degree=0,
        max_sh_degree=max_sh_degree)


def make_optimizer(table: GaussianTable, cfg: OptimizationConfig,
                   spatial_lr_scale: float):
    """Adam (eps 1e-15) with one named parameter group per table field at the
    reference's rates, and the xyz schedule: (optimizer, schedule)."""
    xyz_sched = get_expon_lr_func(cfg.position_lr_init * spatial_lr_scale,
                                  cfg.position_lr_final * spatial_lr_scale,
                                  lr_delay_mult=cfg.position_lr_delay_mult,
                                  max_steps=cfg.position_lr_max_steps)
    lr = {"xyz": xyz_sched(0), "f_dc": cfg.feature_lr, "f_rest": cfg.feature_lr / 20.0,
          "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
          "rotation": cfg.rotation_lr, "obj_dc": cfg.feature_lr}
    groups = [{"params": [getattr(table, f)], "lr": lr[g], "name": g}
              for f, g in GROUP_OF_FIELD.items()]
    return torch.optim.Adam(groups, eps=1e-15), xyz_sched


def init_state(table: GaussianTable, cfg: OptimizationConfig, spatial_lr_scale: float,
               seed: int = 0, code_book: Optional[torch.Tensor] = None) -> TrainState:
    """Train state over ``table``, whose parameter tensors become leaf tensors
    that require grad. The codebook is initialised like a conv kernel,
    U(±1/√16), from a generator seeded with ``seed`` unless given."""
    dev = table.xyz.device
    for f in PARAM_FIELDS:
        getattr(table, f).requires_grad_(True)
    if code_book is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        scale = 1.0 / np.sqrt(NUM_OBJECTS)
        code_book = (torch.rand((NUM_CODEBOOK, NUM_OBJECTS), generator=gen, device=dev)
                     * 2 - 1) * scale
    code_book = code_book.detach().clone().requires_grad_(True)
    gauss_opt, xyz_sched = make_optimizer(table, cfg, spatial_lr_scale)
    cls_opt = torch.optim.Adam([code_book], lr=cfg.codebook_lr)
    return TrainState(table=table, gauss_opt=gauss_opt, code_book=code_book,
                      cls_opt=cls_opt, stats=DensifyStats.zero(table.capacity, dev),
                      step=0, xyz_schedule=xyz_sched)


def compute_losses(table: GaussianTable, code_book: torch.Tensor, camera: Camera,
                   gt_image: torch.Tensor, gt_obj: torch.Tensor, bg: torch.Tensor,
                   cfg: OptimizationConfig, offset: torch.Tensor, raster_kw: dict,
                   generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None,
                   shard_logits: Optional[Callable] = None):
    """The loss pipeline of one view: (total, aux dict). ``idx`` is the
    contrastive loss's pixel sample (drawn from ``generator`` when not given).

    ``shard_logits(code_book, features [16, P]) → [256, P]`` computes the
    codebook logits in place of ``code_book @ features``: the tensor-parallel
    step (parallel/train.py) computes a rank's rows and gathers the rest.

    Runs in the span ``train.losses``."""
    with annotate("train.losses"):
        out = render(table, camera, bg, means2d_offset=offset, **raster_kw)
        image, objects = out["render"], out["render_object"]

        ll1 = L.l1_loss(image, gt_image)
        dssim = 1.0 - L.ssim(image, gt_image)
        contrast, reg = L.contrastive_loss(objects, gt_obj, generator=generator, idx=idx)
        # one [P, 256] one-hot shared by the confidence map and the virtual-GT cost
        lab_oh = L._label_onehot(torch.clamp(gt_obj.reshape(-1), 0, L.NUM_CLUSTERS - 1))
        conf = L.confidence_map(objects, gt_obj, onehot=lab_oh)
        # codebook logits on detached features (train_unified_lift.py:371)
        obj_flat = objects.detach().reshape(NUM_OBJECTS, -1)
        logits = (code_book @ obj_flat if shard_logits is None
                  else shard_logits(code_book, obj_flat)).reshape(NUM_CODEBOOK, *gt_obj.shape)
        vgt = L.virtual_gt_labels(gt_obj, logits, onehot=lab_oh)
        cls_loss = L.gated_classification_loss(logits, vgt, conf, cfg.num_classes)
        clu_loss = L.clustering_loss(objects, vgt, code_book, conf)

        total = ((1.0 - cfg.lambda_dssim) * ll1 + cfg.lambda_dssim * dssim
                 + cfg.w_contrastive * contrast + cfg.w_cls * cls_loss
                 + cfg.w_clustering * clu_loss + cfg.w_reg * reg)
        aux = {"l1": ll1, "dssim": dssim, "contrastive": contrast, "cls": cls_loss,
               "clustering": clu_loss, "reg": reg, "total": total,
               "radii": out["radii"], "visible": out["visibility_filter"],
               "psnr": L.psnr(image, gt_image), "num_pairs": out["num_pairs"],
               "tile_overflow": out["tile_overflow"]}
        return total, aux


METRIC_KEYS = ("l1", "dssim", "contrastive", "cls", "clustering", "reg", "total",
               "psnr", "num_pairs", "tile_overflow")


def apply_updates(state: TrainState) -> None:
    """One update of both optimizers from the gradients on their parameters,
    the xyz rate taken from the schedule at the number of updates so far (as
    optax counts: 0 on the first)."""
    for group in state.gauss_opt.param_groups:
        if group["name"] == "xyz":
            group["lr"] = state.xyz_schedule(state.step)
    state.gauss_opt.step()
    state.cls_opt.step()


def make_train_step(cfg: OptimizationConfig, raster_kw: Optional[dict] = None):
    """The single-view train step: ``step(state, camera, gt_image [3,H,W],
    gt_obj [H,W], bg [3], generator=None, idx=None) → metrics`` (0-dim
    tensors). It updates ``state`` in place.

    The step runs in the span ``train.step``, which counts the device
    allocations it makes; inside it ``train.losses``, ``train.backward``,
    ``train.adam`` (the gradients' reset, then the update) and
    ``train.stats``."""
    raster_kw = dict(raster_kw or {})

    def train_step(state: TrainState, camera: Camera, gt_image: torch.Tensor,
                   gt_obj: torch.Tensor, bg: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None) -> dict:
        with annotate("train.step", allocs=True):
            table = state.table
            offset = torch.zeros((table.capacity, 2), dtype=torch.float32,
                                 device=table.xyz.device, requires_grad=True)
            total, aux = compute_losses(table, state.code_book, camera, gt_image, gt_obj,
                                        bg, cfg, offset, raster_kw, generator=generator,
                                        idx=idx)
            with annotate("train.adam"):
                state.gauss_opt.zero_grad(set_to_none=True)
                state.cls_opt.zero_grad(set_to_none=True)
            with annotate("train.backward"):
                total.backward()
            with annotate("train.adam"):
                apply_updates(state)
            with annotate("train.stats"):
                state.stats = add_stats(state.stats, offset.grad, aux["visible"],
                                        aux["radii"])
            state.step += 1
            return {k: aux[k].detach() for k in METRIC_KEYS}

    return train_step


def one_up_sh_degree(table: GaussianTable) -> GaussianTable:
    """Raise the active SH degree, capped at the max (every 1000 iterations in
    the reference)."""
    return dataclasses.replace(
        table, active_sh_degree=min(table.active_sh_degree + 1, table.max_sh_degree))
