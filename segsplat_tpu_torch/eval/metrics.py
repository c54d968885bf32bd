"""Segmentation + image metrics (numpy: they run on rendered outputs on the
host), a copy of segsplat_tpu/eval/metrics.py, which imports no JAX.

Definitions transcribed from the reference:
  * mask IoU at threshold 128 on uint8 masks (eval_lerf_mask_unified_lift.py:64-71),
  * Boundary IoU via distance-transform-free erosion boundary extraction with
    dilation radius 0.02·image-diagonal (eval_lerf_mask_unified_lift.py:13-51,
    following the Boundary IoU paper's public formulation),
  * mIoU / fwIoU over a label confusion matrix (ScanNet++ protocol,
    README.md:101-103),
  * PSNR (utils/image_utils.py:14-19).
"""

from __future__ import annotations

import numpy as np


# ───────────────────────────── binary-mask metrics ─────────────────────────────

def mask_iou(pred: np.ndarray, gt: np.ndarray, threshold: int = 128) -> float:
    """IoU of two uint8 masks binarized at ``threshold`` (reference :64-71)."""
    p = np.asarray(pred) > threshold
    g = np.asarray(gt) > threshold
    union = np.logical_or(p, g).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, g).sum() / union)


def _mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """Boundary band of a binary mask: mask minus its erosion by d pixels,
    d = round(dilation_ratio · image diagonal) (reference :13-33, which uses
    cv2.erode with a (3,3) kernel d times; reproduced with a pure-numpy erosion
    so the metric has no cv2 dependency)."""
    mask = (np.asarray(mask) > 0).astype(np.uint8)
    h, w = mask.shape
    img_diag = np.sqrt(h ** 2 + w ** 2)
    dilation = max(1, int(round(dilation_ratio * img_diag)))

    # erosion with 1-px zero border, 3x3 structuring element, `dilation` times
    # (matches cv2.erode on a zero-padded image as the reference does :24-28)
    eroded = np.pad(mask, 1)
    for _ in range(dilation):
        m = eroded
        inner = (m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2]
                 & m[1:-1, 2:] & m[:-2, :-2] & m[:-2, 2:] & m[2:, :-2] & m[2:, 2:])
        eroded = np.pad(inner, 1)
    eroded = eroded[1:-1, 1:-1]
    return mask - (mask & eroded)


def boundary_iou(gt: np.ndarray, pred: np.ndarray,
                 dilation_ratio: float = 0.02, threshold: int = 128) -> float:
    """Boundary IoU (reference :34-51)."""
    g = (np.asarray(gt) > threshold).astype(np.uint8)
    p = (np.asarray(pred) > threshold).astype(np.uint8)
    gb = _mask_to_boundary(g, dilation_ratio)
    pb = _mask_to_boundary(p, dilation_ratio)
    union = ((gb + pb) > 0).sum()
    if union == 0:
        return 1.0
    return float(((gb * pb) > 0).sum() / union)


# ───────────────────────────── multi-class metrics ─────────────────────────────

def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                     ignore_label: int = -1) -> np.ndarray:
    """[C, C] confusion matrix, rows = GT, cols = prediction."""
    pred = np.asarray(pred).reshape(-1)
    gt = np.asarray(gt).reshape(-1)
    valid = (gt != ignore_label) & (gt >= 0) & (gt < num_classes)
    pred = np.clip(pred[valid], 0, num_classes - 1)
    gt = gt[valid]
    idx = gt.astype(np.int64) * num_classes + pred.astype(np.int64)
    return np.bincount(idx, minlength=num_classes ** 2).reshape(num_classes,
                                                                num_classes)


def iou_per_class(conf: np.ndarray) -> np.ndarray:
    """Per-class IoU from a confusion matrix; NaN for absent classes."""
    conf = conf.astype(np.float64)
    tp = np.diag(conf)
    denom = conf.sum(axis=1) + conf.sum(axis=0) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, tp / denom, np.nan)


def miou_from_confusion(conf: np.ndarray) -> float:
    iou = iou_per_class(conf)
    return float(np.nanmean(iou)) if np.any(~np.isnan(iou)) else 0.0


def mean_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int,
             ignore_label: int = -1) -> float:
    """mIoU (ScanNet++ protocol)."""
    return miou_from_confusion(confusion_matrix(pred, gt, num_classes, ignore_label))


def fw_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int,
           ignore_label: int = -1) -> float:
    """Frequency-weighted IoU: Σ_c (freq_c · IoU_c)."""
    conf = confusion_matrix(pred, gt, num_classes, ignore_label)
    iou = iou_per_class(conf)
    freq = conf.sum(axis=1) / max(conf.sum(), 1)
    return float(np.nansum(np.where(np.isnan(iou), 0.0, iou) * freq))


# ───────────────────────────── image metrics ─────────────────────────────

def psnr_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR over [0,1] images (utils/image_utils.py:17-19)."""
    mse = np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(1.0 / np.sqrt(mse)))
