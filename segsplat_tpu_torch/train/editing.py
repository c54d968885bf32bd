"""Object editing on the GaussianTable (the counterpart of
segsplat_tpu/train/editing.py, after the reference's
scene/gaussian_model.py:187-353): the codebook classification and the IoA
selection of the editing and LERF workflows (ext/grounded_sam.py:102-115
``select_obj_ioa``), object removal (``removal_setup``), the inpainting set-up
that seeds replacement rows in the hole (``inpaint_setup``) and the gradient
mask of the masked finetune (``finetune_grad_mask``).

Each edit returns a new table and leaves the one it was given as it was. The
inpainting set-up runs on the host with the JAX package's numpy and scipy
calls, so both packages seed the same rows from the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from segsplat_tpu_torch.core.types import GaussianTable
from segsplat_tpu_torch.train.densify import PARAM_FIELDS


def classify_gaussians(table: GaussianTable, code_book) -> np.ndarray:
    """Per-Gaussian class id [capacity]: the argmax of the codebook logits of
    the 16-D identity features (the first maximum, as ``jnp.argmax``), on the
    table's device."""
    obj = table.objects_dc[:, 0, :]                                   # [C, 16]
    cb = torch.as_tensor(code_book, dtype=obj.dtype, device=obj.device)
    return torch.argmax(obj @ cb.T, dim=1).cpu().numpy()             # [C]


def mask3d_from_classes(table: GaussianTable, code_book,
                        selected_ids: Sequence[int]) -> np.ndarray:
    """[capacity] bool: the active rows whose identity class is in
    ``selected_ids``."""
    cls = classify_gaussians(table, code_book)
    sel = np.isin(cls, np.asarray(list(selected_ids)))
    return sel & table.active.cpu().numpy()


def removal_setup(table: GaussianTable, mask3d: np.ndarray) -> GaussianTable:
    """Remove the masked Gaussians (removal_setup, gaussian_model.py:222-248):
    their ``active`` bit is cleared. The fixed-capacity table renders as if
    they were dropped, and save_gaussian_table writes only live rows."""
    keep = table.active.cpu().numpy() & ~np.asarray(mask3d, bool)
    return dataclasses.replace(table, active=torch.from_numpy(keep).to(table.active.device))


def inpaint_setup(table: GaussianTable, mask3d: np.ndarray,
                  num_new_points: Optional[int] = None, k: int = 5,
                  seed: int = 0) -> Tuple[GaussianTable, np.ndarray]:
    """Remove the masked Gaussians and seed replacements in the hole
    (inpaint_setup, gaussian_model.py:250-330): each new point sits near a
    removed one, drawn with ``default_rng(seed)``, and copies the parameters
    of one of its k nearest remaining Gaussians (scipy's cKDTree). The new rows
    take the first free rows of the table. Returns (table, new-row mask
    [capacity] bool), the mask being the finetune's trainable set."""
    from scipy.spatial import cKDTree

    act = table.active.cpu().numpy()
    sel = np.asarray(mask3d, bool) & act
    keep = act & ~sel
    if num_new_points is None:
        num_new_points = int(sel.sum())

    xyz = table.xyz.detach().cpu().numpy()
    hole_xyz = xyz[sel]
    rng = np.random.default_rng(seed)
    if num_new_points == 0 or len(hole_xyz) == 0 or keep.sum() == 0:
        return removal_setup(table, mask3d), np.zeros(table.capacity, bool)
    qi = rng.integers(0, len(hole_xyz), num_new_points)
    query = hole_xyz[qi] + rng.normal(0, 0.01, (num_new_points, 3))

    _, nbr = cKDTree(xyz[keep]).query(query, k=min(k, int(keep.sum())))
    # k = 1 returns a flat [N] array: one neighbour a query row
    nbr = np.asarray(nbr).reshape(len(query), -1)
    keep_rows = np.flatnonzero(keep)
    pick = nbr[np.arange(num_new_points), rng.integers(0, nbr.shape[1], num_new_points)]
    src_rows = keep_rows[pick]

    free = np.flatnonzero(~keep)[:num_new_points]
    n_new = len(free)
    dev = table.xyz.device

    def place(field, new_vals=None):
        arr = getattr(table, field).detach().cpu().numpy().copy()
        arr[free] = new_vals if new_vals is not None else arr[src_rows[:n_new]]
        return torch.from_numpy(arr).to(dev)

    new_active = keep.copy()
    new_active[free] = True
    new_mask = np.zeros(table.capacity, bool)
    new_mask[free] = True
    fields = {f: place(f) for f in PARAM_FIELDS if f != "xyz"}
    edited = dataclasses.replace(table, xyz=place("xyz", query[:n_new].astype(np.float32)),
                                 active=torch.from_numpy(new_active).to(dev), **fields)
    return edited, new_mask


def finetune_grad_mask(trainable_rows: np.ndarray) -> Callable[[Dict[str, torch.Tensor]], None]:
    """The masked finetune's gradient hook (finetune_setup's register_hook,
    gaussian_model.py:187-205), as a callable on a dict of the table's
    parameter tensors: after ``backward()`` it multiplies each one's ``.grad``
    in place by the row mask and zeroes ``objects_dc.grad`` (the identity
    features stay frozen). Use before the optimizer's step."""
    rows = torch.from_numpy(np.asarray(trainable_rows, np.float32))
    on = {}

    def apply(params: Dict[str, torch.Tensor]) -> None:
        for name, p in params.items():
            g = p.grad
            if g is None:
                continue
            if name == "objects_dc":
                g.zero_()
                continue
            if g.device not in on:
                on[g.device] = rows.to(g.device)
            g.mul_(on[g.device].reshape((-1,) + (1,) * (g.ndim - 1)))

    return apply


def select_obj_ioa(pred_masks: np.ndarray, sam_mask: np.ndarray,
                   threshold: float = 0.7) -> list:
    """Class ids whose rendered mask lies mostly inside the text-query mask:
    intersection over the class's area > ``threshold`` (ext/grounded_sam.py:
    102-115). pred_masks: [H, W] int class-id map; sam_mask: [H, W] bool or
    0-1."""
    sam = np.asarray(sam_mask) > 0
    out = []
    for cid in np.unique(pred_masks):
        m = pred_masks == cid
        area = m.sum()
        if area == 0:
            continue
        if (m & sam).sum() / area > threshold:
            out.append(int(cid))
    return out
