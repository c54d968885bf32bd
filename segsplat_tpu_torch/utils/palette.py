"""Label→colour palette for semantic masks."""

from __future__ import annotations

import numpy as np


def bit_shuffle_palette(num_classes: int) -> np.ndarray:
    """[num_classes, 3] uint8: class id bits spread across RGB MSBs (the
    PASCAL-VOC palette the reference's get_palette builds)."""
    out = np.zeros((num_classes, 3), np.uint8)
    for j in range(num_classes):
        lab = j
        r = g = b = 0
        i = 0
        while lab > 0:
            r |= ((lab >> 0) & 1) << (7 - i)
            g |= ((lab >> 1) & 1) << (7 - i)
            b |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
        out[j] = (r, g, b)
    return out


def colorize_labels(labels: np.ndarray, num_classes: int | None = None) -> np.ndarray:
    """[...] int labels → [..., 3] uint8 colours by the bit-shuffle palette;
    labels past the last class take its colour."""
    labels = np.asarray(labels)
    n = int(num_classes if num_classes is not None else labels.max() + 1)
    pal = bit_shuffle_palette(max(n, 1))
    return pal[np.clip(labels, 0, n - 1)]
