"""Object selection on the GaussianTable: the codebook classification and the
IoA selection of the reference's editing and LERF workflows
(ext/grounded_sam.py:102-115 ``select_obj_ioa``; edit_object_removal's
classification). The counterpart of part of segsplat_tpu/train/editing.py:
``classify_gaussians``, ``mask3d_from_classes`` and ``select_obj_ioa``. The
edits themselves (``removal_setup``, ``inpaint_setup``, ``finetune_grad_mask``)
are not ported yet (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from segsplat_tpu_torch.core.types import GaussianTable


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
