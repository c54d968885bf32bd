"""Semantic novel-view rendering (stage L6, the FPS-metric path).

Load a trained scene, attach per-Gaussian semantic logits (padded or sliced to
32 channels at raster time), rasterize the logit payload per view, argmax →
label map, and save per view: ``*_labels.pt`` {label_indices}, a palette mask
PNG, raw ``*_logits.npy`` (fp16) and a confidence PNG (top1 − top2 softmax
margin, logit_confidence_map.py:6-25). ``semantic_view_products`` gives each
view's arrays on the host, ``write_view_artifacts`` writes them.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from segsplat_tpu_torch.io.artifacts import load_semantics, save_label_map
from segsplat_tpu_torch.io.provenance import read_weights_source, require_untainted
from segsplat_tpu_torch.render import render_semantics_many
from segsplat_tpu_torch.utils.palette import bit_shuffle_palette
from segsplat_tpu_torch.utils.profiling import annotate, count
from segsplat_tpu_torch.utils.system import mkdir_p


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


class ViewProducts(NamedTuple):
    """One view's arrays, on the host, that every artifact is made from."""
    index: int
    labels: np.ndarray          # [H, W] int32, the argmax over the P logits
    logits: np.ndarray          # [P, H, W] float16, as the ``.npy`` holds them
    confidence: np.ndarray      # [H, W] float32, top1 − top2 softmax margin
    num_pairs: int              # the view's real pairs, before any pair cap
    tile_overflow: int          # pairs past the per-tile cap K


def semantic_view_products(table, cameras: Sequence, logits: torch.Tensor, *,
                           bg_value: float = 0.0, backend: str = "cuda",
                           max_tiles_per_axis: int = 6, max_per_tile: int = 256,
                           pair_cap: Optional[int] = None,
                           view_batch: int = 8) -> Iterator[ViewProducts]:
    """Stage 5's per-view products: the views of ``render_semantics_many``
    (queued ``view_batch`` at a time, one host sync a batch), each fetched to
    the host and post-processed there. Yields a ``ViewProducts`` a camera.

    logits: [capacity, P] per-Gaussian logits on the table's device.
    pair_cap: None takes no cap; a cap below a view's pairs drops the deepest
    runs of the highest tile ids (``ops/rasterize.bin_pairs``); the dense
    backend takes none.

    Spans (``utils/profiling``): ``render_cli.view`` a view, counting
    ``pairs`` and ``dropped`` (the pairs past ``pair_cap``, 0 without one);
    inside it ``render_cli.batch`` where the view starts a batch (the batch's
    enqueue and its counter sync, ``render.*``/``raster.*`` inside),
    ``render_cli.fetch`` (the wait for the view and the logits' copy to the
    host), ``render_cli.labels`` (the argmax) and ``render_cli.confidence``
    (the float64 confidence and the fp16 cast)."""
    n_prompts = logits.shape[1]
    cap = pair_cap if backend == "cuda" else None         # the dense blend takes no cap
    B = max(1, view_batch)
    views = render_semantics_many(
        table, cameras, logits, bg_value=bg_value, max_tiles_per_axis=max_tiles_per_axis,
        max_per_tile=max_per_tile, backend=backend, pair_cap=pair_cap, view_batch=B)
    for k in range(len(cameras)):
        with annotate("render_cli.view"):
            if k % B == 0:
                with annotate("render_cli.batch"):
                    i, sem, aux = next(views)
            else:
                i, sem, aux = next(views)
            npairs = aux["num_pairs"]
            count("pairs", npairs)
            count("dropped", max(npairs - cap, 0) if cap is not None else 0)
            with annotate("render_cli.fetch"):
                sem_np = sem[:n_prompts].cpu().numpy()            # [P, H, W]
            with annotate("render_cli.labels"):
                labels = sem_np.argmax(axis=0).astype(np.int32)
            with annotate("render_cli.confidence"):
                conf = confidence_from_logits(sem_np, axis=0)
                half = sem_np.astype(np.float16)
        yield ViewProducts(i, labels, half, conf, npairs, aux["tile_overflow"])


def write_view_artifacts(out_dir: str, record: ViewProducts, palette: np.ndarray,
                         prompts: Optional[Sequence[str]] = None,
                         save_logits: bool = True) -> None:
    """A view's artifact set from its products: ``*_labels.pt``, the palette
    mask PNG, the fp16 ``*_logits.npy`` (with ``save_logits``), the
    confidence PNGs and, with ``prompts``, the legend PNG. In the span
    ``render_cli.write``."""
    with annotate("render_cli.write"):
        name = f"{record.index:05d}"
        labels = record.labels
        save_label_map(os.path.join(out_dir, f"{name}_labels.pt"), labels)
        Image.fromarray(palette[labels]).save(os.path.join(out_dir, f"{name}_mask_color.png"))
        if save_logits:
            np.save(os.path.join(out_dir, f"{name}_logits.npy"), record.logits)
        save_confidence_png(os.path.join(out_dir, f"{name}_confidence.png"), record.confidence)
        if prompts is not None:
            _save_legend_png(os.path.join(out_dir, f"{name}_legend.png"),
                             labels, palette, prompts)


def render_semantic_views(table, cameras: Sequence, logits: np.ndarray,
                          out_dir: str, prompts: Optional[Sequence[str]] = None,
                          bg_value: float = 0.0, save_logits: bool = True,
                          backend: str = "cuda",
                          max_tiles_per_axis: int = 6,
                          max_per_tile: int = 256,
                          pair_cap: Optional[int] = None,
                          view_batch: int = 8) -> List[np.ndarray]:
    """Render every camera on the table's device; write the per-view artifact
    set (``semantic_view_products``, then ``write_view_artifacts``). Returns
    the [H, W] int32 label maps.

    table: GaussianTable; cameras: list of Camera on the same device;
    logits: [capacity, P] per-Gaussian logits (attach_logits_for_table).
    backend: "cuda" (the kernels) or "dense" (torch ops; the JAX package's
    "pallas" and "xla"). pair_cap: None takes no cap, as ``render_semantics``
    and the viewer do; the dense backend takes none. Truncation is never
    silent: views whose pair count exceeds the cap, or whose tiles exceed K,
    warn."""
    mkdir_p(out_dir)
    pal = bit_shuffle_palette(max(logits.shape[1], 1))
    logits_t = torch.as_tensor(np.asarray(logits, np.float32), device=table.xyz.device)
    label_maps = []
    for rec in semantic_view_products(
            table, cameras, logits_t, bg_value=bg_value, backend=backend,
            max_tiles_per_axis=max_tiles_per_axis, max_per_tile=max_per_tile,
            pair_cap=pair_cap, view_batch=view_batch):
        i, npairs = rec.index, rec.num_pairs
        if pair_cap is not None and npairs > pair_cap:
            print(f"[WARN] view {i}: {npairs} pairs > pair_cap {pair_cap} — "
                  f"deepest pairs dropped; raise pair_cap")
        if rec.tile_overflow:
            print(f"[WARN] view {i}: {rec.tile_overflow} pairs beyond per-tile K="
                  f"{max_per_tile} — raise max_per_tile")
        label_maps.append(rec.labels)
        write_view_artifacts(out_dir, rec, pal, prompts, save_logits)
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
