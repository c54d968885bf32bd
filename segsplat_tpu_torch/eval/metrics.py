"""Image metrics of the training report (the counterpart of the image part of
segsplat_tpu/eval/metrics.py)."""

from __future__ import annotations

import numpy as np


def psnr_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR over [0, 1] images, in float64 (the reference's utils/image_utils.py)."""
    mse = np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(1.0 / np.sqrt(mse)))
