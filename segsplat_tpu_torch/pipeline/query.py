"""Voxel→Gaussian transfer and open-vocabulary querying, stages 3-4 of
run_pipeline.py (the counterpart of segsplat_tpu/pipeline/query.py, after the
reference's voxeltoGaussian_logits.py subcommands convert / build_map / query,
voxeltovoxel_logits.py and extract_gaussian_centers.py).

  * ``build_map``: the exact 1-NN voxel of each Gaussian centre
    (ops/knn.nearest_neighbor_index, a chunked distance argmin on the device;
    the reference uses a CPU KD-tree),
  * ``query``: prompts → text embeddings, the whole voxel table scored in one
    product on the device (models/clip_text.project_features_to_labels) and
    its argmax, gathered onto the Gaussians on the host through the map, and
    written as the ``gaussian_semantics`` .npz {labels, logits, prompts} with
    two PLYs coloured by the palette.

Without a text model (a ``TextTower`` built from converted CLIP weights) the
prompts get the JAX package's deterministic sha256-seeded hash embeddings,
with a warning: the labels then carry no meaning. A failure of a given text
model raises.

The query's stages run inside spans (``utils/profiling.annotate``:
``query.load``, ``query.project``, ``query.fetch``, ``query.gather``,
``query.npz``, ``query.ply``), so a profiler attributes its device and host
time per stage.
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence

import numpy as np
import torch

from segsplat_tpu_torch.io.artifacts import load_voxel_features, save_semantics
from segsplat_tpu_torch.io.ply import read_ply, write_voxel_grid_ply
from segsplat_tpu_torch.io.provenance import (read_weights_source, require_untainted,
                                              write_provenance)
from segsplat_tpu_torch.models.clip_text import project_features_to_labels
from segsplat_tpu_torch.ops.knn import nearest_neighbor_index
from segsplat_tpu_torch.utils.palette import bit_shuffle_palette
from segsplat_tpu_torch.utils.profiling import annotate
from segsplat_tpu_torch.utils.system import require_device

LERF_NEGATIVES = ("object", "things", "stuff", "texture")


def extract_gaussian_centers(ply_path: str, out_path: str) -> np.ndarray:
    """Gaussian checkpoint PLY → mu [M, 3] .npy/.npz
    (extract_gaussian_centers.py:15-50)."""
    mu = read_ply(ply_path).xyz().astype(np.float32)
    if out_path.endswith(".npz"):
        np.savez(out_path, mu=mu)
    else:
        np.save(out_path, mu)
    return mu


def load_gaussian_centers(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        d = np.load(path)
        return d["mu"] if "mu" in d else d[d.files[0]]
    if path.endswith(".ply"):
        return read_ply(path).xyz().astype(np.float32)
    return np.load(path)


def convert_pt_to_npz(pt_path: str, out_path: str) -> None:
    """.pt/.pth voxel features → .npz (the reference's ``convert`` subcommand)."""
    np.savez_compressed(out_path, **load_voxel_features(pt_path))
    _propagate_provenance(pt_path, out_path, stage="convert")


def _propagate_provenance(src_path: str, out_path: str, stage: str) -> None:
    """Carry the weights-provenance sidecar from ``src_path``'s directory to
    ``out_path``'s: the taint must survive format conversions."""
    ws = read_weights_source(src_path)
    if ws is not None:
        write_provenance(os.path.dirname(os.path.abspath(out_path)) or ".", ws, stage=stage)


def _check_taint(voxel_features_path: str, allow: bool, strict: bool = False):
    ws = read_weights_source(voxel_features_path)
    require_untainted(ws, allow, f"voxel features {voxel_features_path}", strict=strict)
    return ws


def build_map(voxel_features_path: str, gaussians_path: str, out_path: str,
              device: str | torch.device = "cuda") -> np.ndarray:
    """1-NN voxel index per Gaussian centre → gauss2voxel.npy (int64)
    (voxeltoGaussian_logits.py:86-105), computed on ``device`` in chunks of
    4 096 centres (the reference's KD-tree batch has no counterpart)."""
    device = require_device(device)
    vox = load_voxel_features(voxel_features_path)
    mu = load_gaussian_centers(gaussians_path)
    f32 = dict(dtype=torch.float32, device=device)
    idx = nearest_neighbor_index(torch.as_tensor(np.asarray(mu, np.float32), **f32),
                                 torch.as_tensor(np.asarray(vox["pos"], np.float32), **f32))
    idx = idx.cpu().numpy()
    np.save(out_path, idx.astype(np.int64))
    return idx


def label_voxels(feats: torch.Tensor, text_emb: torch.Tensor, logit_scale: float):
    """Score the voxel table [V, C] against the prompts' embeddings [P, C] on
    their device: (logits [V, P], labels [V] int64, the first of equal maxima
    as numpy's argmax takes it)."""
    logits = project_features_to_labels(feats, text_emb, logit_scale)
    return logits, torch.argmax(logits, dim=1)


def _score_table(voxel_features_path: str, prompts: Sequence[str], text_model,
                 logit_scale: float, device: torch.device):
    """(voxel artifact, logits [V, P] and labels [V] as numpy)."""
    with annotate("query.load"):
        vox = load_voxel_features(voxel_features_path)
        feats = torch.as_tensor(np.asarray(vox["feat"], np.float32), device=device)
        text_emb = torch.as_tensor(_encode_prompts(prompts, text_model, feats.shape[-1]),
                                   dtype=torch.float32, device=device)
    with annotate("query.project"):
        logits, labels = label_voxels(feats, text_emb, logit_scale)
    with annotate("query.fetch"):
        return vox, logits.cpu().numpy(), labels.cpu().numpy()


def query(voxel_features_path: str, map_path: str, gaussians_path: str,
          prompts: Sequence[str], out_path: str, text_model=None,
          logit_scale: float = 1.0 / 0.07, save_ply: bool = True,
          allow_random_weights: bool = False, require_provenance: bool = False,
          device: str | torch.device = "cuda") -> dict:
    """Open-vocabulary query: encode the prompts, project the 512-D voxel
    features to per-prompt logits on ``device``, take each voxel's argmax,
    gather onto the Gaussians through the 1-NN map, and save the .npz
    {labels, logits, prompts} and the coloured ``_gaussians.ply`` and
    ``_voxels.ply`` (voxeltoGaussian_logits.py:162-344)."""
    device = require_device(device)
    _check_taint(voxel_features_path, allow_random_weights, strict=require_provenance)
    vox, logits, voxel_cls = _score_table(voxel_features_path, prompts, text_model,
                                          logit_scale, device)
    with annotate("query.gather"):
        g2v = np.load(map_path)
        g_labels = voxel_cls[g2v]
        g_logits = logits[g2v]

    with annotate("query.npz"):
        save_semantics(out_path, labels=g_labels, logits=g_logits, prompts=prompts)
        _propagate_provenance(voxel_features_path, out_path, stage="query")
    if save_ply:
        with annotate("query.ply"):
            mu = load_gaussian_centers(gaussians_path)   # only the PLY needs it
            pal = bit_shuffle_palette(max(len(prompts), 1))
            base = os.path.splitext(out_path)[0]
            write_voxel_grid_ply(base + "_gaussians.ply", mu, pal[g_labels],
                                 voxel_size=0.0, grid_origin=np.zeros(3))
            write_voxel_grid_ply(base + "_voxels.ply", np.asarray(vox["pos"]),
                                 pal[voxel_cls], voxel_size=0.0, grid_origin=np.zeros(3))
    return {"labels": g_labels, "logits": g_logits, "voxel_labels": voxel_cls}


def query_voxels(voxel_features_path: str, prompts: Sequence[str], out_path: str,
                 text_model=None, logit_scale: float = 1.0 / 0.07,
                 allow_random_weights: bool = False, require_provenance: bool = False,
                 device: str | torch.device = "cuda") -> dict:
    """Voxel-level variant (voxeltovoxel_logits.py:138-291): labels stay on
    the voxels, no Gaussian map."""
    device = require_device(device)
    _check_taint(voxel_features_path, allow_random_weights, strict=require_provenance)
    vox, logits, labels = _score_table(voxel_features_path, prompts, text_model,
                                       logit_scale, device)
    save_semantics(out_path, labels=labels, logits=logits, prompts=prompts)
    _propagate_provenance(voxel_features_path, out_path, stage="query_voxels")
    pal = bit_shuffle_palette(max(len(prompts), 1))
    write_voxel_grid_ply(os.path.splitext(out_path)[0] + "_voxels.ply",
                         np.asarray(vox["pos"]), pal[labels], voxel_size=0.0,
                         grid_origin=np.zeros(3))
    return {"labels": labels, "logits": logits}


def hash_prompt_embeddings(prompts: Sequence[str], feat_dim: int) -> np.ndarray:
    """[P, feat_dim] unit embeddings, each drawn by numpy's default_rng seeded
    with the first 4 bytes (little-endian) of the prompt's sha256: the same
    bits in every process (Python's ``hash`` is salted per process)."""
    rngs = [np.random.default_rng(int.from_bytes(
        hashlib.sha256(p.encode()).digest()[:4], "little")) for p in prompts]
    emb = np.stack([r.standard_normal(feat_dim) for r in rngs]).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _encode_prompts(prompts: Sequence[str], text_model, feat_dim: int) -> np.ndarray:
    """Prompts → [P, D] embeddings through ``text_model``; without one, the
    hash embeddings, with a warning (the logits are then NOT semantically
    meaningful). Real CLIP weights arrive only as a ``text_model`` (a
    ``TextTower`` built from a state dict): a tower built here would be
    seeded random weights, which the JAX function also sends to the hash
    branch. A failure of the given model raises."""
    if text_model is not None:
        return np.asarray(text_model.encode_prompts(prompts))
    print("[WARN] CLIP text tower unavailable (no converted CLIP text weights given); "
          "using deterministic hash embeddings — labels will not be semantically "
          "meaningful")
    return hash_prompt_embeddings(prompts, feat_dim)


def text_query_mask(feature_map: np.ndarray, prompt: str,
                    negatives: Sequence[str] = LERF_NEGATIVES, threshold: float = 0.5,
                    channels_first: bool = False, text_model=None,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """LSeg-native text grounding (the in-framework replacement for the
    reference's GroundingDINO+SAM frame-0 query): per-pixel LSeg features
    scored against the prompt and the canonical LERF negatives, the LERF
    relevancy min over negatives of the pairwise softmax
    sigmoid(s_prompt − s_negative), thresholded, on ``device``.

    feature_map: [H, W, C] ([C, H, W] with ``channels_first``, the layout
    the LSeg extraction writes). Returns a boolean [H, W] mask.
    """
    device = require_device(device)
    f = np.asarray(feature_map, np.float32)
    if f.ndim != 3:
        raise ValueError(f"feature map must be 3D, got {f.shape}")
    if channels_first:                  # [C, H, W] → [H, W, C]
        f = np.transpose(f, (1, 2, 0))
    emb = _encode_prompts([prompt, *negatives], text_model, f.shape[-1])
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    feats = torch.as_tensor(np.ascontiguousarray(f), device=device)
    n = feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-12)
    logits = 100.0 * (n @ torch.as_tensor(emb, device=device).T)
    rel = torch.sigmoid(logits[..., 0] - logits[..., 1:].amax(dim=-1))
    return (rel > threshold).cpu().numpy()
