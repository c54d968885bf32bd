"""Semantic novel-view rendering (stage L6, the FPS-metric path).

Load a trained scene, attach per-Gaussian semantic logits (padded or sliced to
32 channels at raster time), rasterize the logit payload per view, argmax →
label map, and save per view: ``*_labels.pt`` {label_indices}, a palette mask
PNG, raw ``*_logits.npy`` (fp16) and a confidence PNG (top1 − top2 softmax
margin, logit_confidence_map.py:6-25).
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from segsplat_tpu_torch.io.artifacts import load_semantics, save_label_map
from segsplat_tpu_torch.io.provenance import read_weights_source, require_untainted
from segsplat_tpu_torch.render import render_semantics_many
from segsplat_tpu_torch.utils.palette import bit_shuffle_palette
from segsplat_tpu_torch.utils.system import mkdir_p

PAIR_CAP_MAX = 3_000_000


def confidence_from_logits(logits: np.ndarray, axis: int = -1) -> np.ndarray:
    """top1 − top2 softmax probability margin. A single-class axis has no
    runner-up: the margin is 1.0 everywhere."""
    x = np.asarray(logits, np.float64)
    if x.shape[axis] == 1:
        return np.ones(np.take(x, 0, axis=axis).shape, np.float32)
    x = x - x.max(axis=axis, keepdims=True)
    p = np.exp(x)
    p /= p.sum(axis=axis, keepdims=True)
    part = np.partition(p, -2, axis=axis)
    return (np.take(part, -1, axis=axis) - np.take(part, -2, axis=axis)).astype(np.float32)


def save_confidence_png(path: str, conf: np.ndarray) -> None:
    """Grayscale confidence PNG, plus a viridis ``_colorbar.png`` when
    matplotlib is available."""
    Image.fromarray((np.clip(conf, 0, 1) * 255).astype(np.uint8)).save(path)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        im = ax.imshow(conf, cmap="viridis", vmin=0, vmax=1)
        fig.colorbar(im, ax=ax)
        ax.set_title("logit confidence (top1 - top2)")
        fig.savefig(os.path.splitext(path)[0] + "_colorbar.png",
                    bbox_inches="tight", dpi=100)
        plt.close(fig)
    except ImportError:
        pass  # matplotlib is optional; the grayscale PNG above always exists
    except Exception as e:
        warnings.warn(f"colorbar confidence PNG failed for {path}: {e!r}")


def render_semantic_views(table, cameras: Sequence, logits: np.ndarray,
                          out_dir: str, prompts: Optional[Sequence[str]] = None,
                          bg_value: float = 0.0, save_logits: bool = True,
                          backend: str = "cuda",
                          max_tiles_per_axis: int = 6,
                          max_per_tile: int = 256,
                          pair_cap: Optional[int] = None,
                          view_batch: int = 8) -> List[np.ndarray]:
    """Render every camera on the table's device; write the per-view artifact
    set. Returns the [H, W] int32 label maps.

    table: GaussianTable; cameras: list of Camera on the same device;
    logits: [capacity, P] per-Gaussian logits (attach_logits_for_table).
    backend: "cuda" (the kernels) or "dense" (torch ops; the JAX package's
    "pallas" and "xla"). pair_cap: None picks min(capacity·m², 3M) for the
    "cuda" backend, as the JAX package does for "pallas"; the dense backend
    takes no cap. Truncation is never silent: views whose pair count exceeds
    the cap, or whose tiles exceed K, warn."""
    mkdir_p(out_dir)
    n_prompts = logits.shape[1]
    pal = bit_shuffle_palette(max(n_prompts, 1))
    logits_t = torch.as_tensor(np.asarray(logits, np.float32), device=table.xyz.device)
    if pair_cap is None and backend == "cuda":
        pair_cap = min(table.capacity * max_tiles_per_axis ** 2, PAIR_CAP_MAX)

    label_maps = []
    for i, sem, aux in render_semantics_many(
            table, cameras, logits_t, bg_value=bg_value,
            max_tiles_per_axis=max_tiles_per_axis, max_per_tile=max_per_tile,
            backend=backend, pair_cap=pair_cap, view_batch=view_batch):
        npairs = aux["num_pairs"]
        if pair_cap is not None and npairs > pair_cap:
            print(f"[WARN] view {i}: {npairs} pairs > pair_cap {pair_cap} — "
                  f"deepest pairs dropped; raise pair_cap")
        ovf = aux["tile_overflow"]
        if ovf:
            print(f"[WARN] view {i}: {ovf} pairs beyond per-tile K="
                  f"{max_per_tile} — raise max_per_tile")
        sem_np = sem[:n_prompts].cpu().numpy()                    # [P, H, W]
        labels = sem_np.argmax(axis=0).astype(np.int32)
        label_maps.append(labels)

        name = f"{i:05d}"
        save_label_map(os.path.join(out_dir, f"{name}_labels.pt"), labels)
        Image.fromarray(pal[labels]).save(os.path.join(out_dir, f"{name}_mask_color.png"))
        if save_logits:
            np.save(os.path.join(out_dir, f"{name}_logits.npy"), sem_np.astype(np.float16))
        conf = confidence_from_logits(sem_np, axis=0)
        save_confidence_png(os.path.join(out_dir, f"{name}_confidence.png"), conf)
        if prompts is not None:
            _save_legend_png(os.path.join(out_dir, f"{name}_legend.png"),
                             labels, pal, prompts)
    return label_maps


def _save_legend_png(path: str, labels: np.ndarray, pal: np.ndarray,
                     prompts: Sequence[str]) -> None:
    """Mask + legend side panel (render_semantics_logits.py:176-222)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 5))
        ax.imshow(pal[labels])
        ax.axis("off")
        patches = [mpatches.Patch(color=pal[c] / 255.0,
                                  label=prompts[c] if c < len(prompts) else str(c))
                   for c in np.unique(labels)]
        ax.legend(handles=patches, loc="center left", bbox_to_anchor=(1.0, 0.5),
                  fontsize=8)
        fig.savefig(path, bbox_inches="tight", dpi=100)
        plt.close(fig)
    except ImportError:
        pass  # matplotlib is optional; labels/mask artifacts always exist
    except Exception as e:
        warnings.warn(f"legend PNG failed for {path}: {e!r}")


def attach_logits_for_table(table, semantics_path: str,
                            allow_random_weights: bool = False) -> np.ndarray:
    """Load a gaussian_semantics .npz and align its [M, P] logits to the
    table's active rows → [capacity, P] float32. Refuses artifacts tainted
    weights_source=random unless ``allow_random_weights``."""
    require_untainted(read_weights_source(semantics_path), allow_random_weights,
                      f"semantics {semantics_path}")
    logits = np.asarray(load_semantics(semantics_path)["logits"], np.float32)
    active = table.active.cpu().numpy()
    if logits.shape[0] != int(active.sum()):
        raise ValueError(f"semantics rows {logits.shape[0]} != active gaussians "
                         f"{int(active.sum())}")
    full = np.zeros((table.capacity, logits.shape[1]), np.float32)
    full[active] = logits
    return full
