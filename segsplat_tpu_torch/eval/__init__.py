"""Evaluation metrics: mIoU/fwIoU (ScanNet++), IoU + Boundary-IoU (LERF-Masked),
PSNR (the reference's metric definitions, README.md:101-103,
script/eval_lerf_mask_unified_lift.py:13-71, utils/image_utils.py:14-19) and
the LPIPS perceptual metric (``eval.lpips``: ``load_lpips``, ``LPIPS`` and the
function ``lpips``, which stays in its module so that the name ``eval.lpips``
is the module, as in the JAX package)."""

from segsplat_tpu_torch.eval.lpips import LPIPS, load_lpips
from segsplat_tpu_torch.eval.metrics import (boundary_iou, confusion_matrix, fw_iou,
                                             iou_per_class, mask_iou, mean_iou,
                                             miou_from_confusion, psnr_np)

__all__ = [
    "LPIPS", "boundary_iou", "confusion_matrix", "fw_iou", "iou_per_class", "load_lpips",
    "mask_iou", "mean_iou", "miou_from_confusion", "psnr_np",
]
