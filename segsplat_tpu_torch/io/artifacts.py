"""Stage-artifact I/O: the lifted voxel features ``ALL_nonzero_voxel_features_*.pt``
{xyz f32, avg_feats fp16, voxel_coords int64} or .npz {pos, feat, coords}
(aggregate_voxel_features_onthefly.py:379-453), the per-image LSeg feature maps
(fp16 [C, H, W] .npy), the ``gaussian_semantics`` .npz {labels, logits, prompts}
(voxeltoGaussian_logits.py:235), the per-view ``*_labels.pt``
{label_indices} (render_semantics_logits.py:141-143) and the identity codebook
(``classifier.npz`` or the reference's ``classifier.pth``)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def save_voxel_features(path: str, xyz: np.ndarray, avg_feats: np.ndarray,
                        voxel_coords: np.ndarray) -> None:
    """The lifted-feature artifact: .pt/.pth in the reference's dict layout,
    any other suffix as .npz {pos, feat, coords}."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith((".pt", ".pth")):
        torch.save({
            "xyz": torch.from_numpy(np.asarray(xyz, np.float32)),
            "avg_feats": torch.from_numpy(np.asarray(avg_feats, np.float16)),
            "voxel_coords": torch.from_numpy(np.asarray(voxel_coords, np.int64)),
        }, path)
    else:
        np.savez_compressed(path, pos=np.asarray(xyz, np.float32),
                            feat=np.asarray(avg_feats, np.float16),
                            coords=np.asarray(voxel_coords, np.int64))


def load_voxel_features(path: str) -> Dict[str, np.ndarray]:
    """A voxel-feature artifact from .pt/.pth or .npz as {pos, feat[, coords]}
    (feat as float32 from a .pt), tolerant of both key sets, as the reference's
    voxeltoGaussian_logits.py load_voxels:40-54."""
    if path.endswith((".pt", ".pth")):
        d = torch.load(path, map_location="cpu", weights_only=True)
        if "xyz" in d and "avg_feats" in d:
            out = {"pos": d["xyz"].float().numpy(), "feat": d["avg_feats"].float().numpy()}
            if "voxel_coords" in d:
                out["coords"] = d["voxel_coords"].numpy()
            return out
        if "pos" in d and "feat" in d:
            return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
                    for k, v in d.items()}
        raise KeyError(f"{path}: missing voxel keys, found {list(d)}")
    d = np.load(path)
    if "pos" in d and "feat" in d:
        return {k: d[k] for k in d.files}
    raise KeyError(f"{path}: missing voxel keys, found {d.files}")


def load_feature_map(path: str) -> np.ndarray:
    """A per-image LSeg feature map [C, H, W] (fp16 .npy, extract_lseg_features.py:95-98)."""
    return np.load(path)


def save_feature_map(path: str, feats: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, np.asarray(feats, np.float16))


def save_semantics(path: str, labels: np.ndarray, logits: np.ndarray, prompts) -> None:
    np.savez(path, labels=np.asarray(labels), logits=np.asarray(logits),
             prompts=np.array(list(prompts)))


def load_semantics(path: str) -> Dict[str, np.ndarray]:
    d = np.load(path, allow_pickle=False)
    return {k: d[k] for k in d.files}


def save_label_map(path: str, label_indices: np.ndarray) -> None:
    """.pt {'label_indices': [H, W]} (.npy for any other suffix)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".pt"):
        torch.save({"label_indices": torch.from_numpy(np.asarray(label_indices))}, path)
    else:
        np.save(path, np.asarray(label_indices))


def load_label_map(path: str) -> np.ndarray:
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)["label_indices"].numpy()
    return np.load(path)


def load_codebook(path: str) -> np.ndarray:
    """The [256, 16] identity codebook, from ``classifier.npz`` (key
    ``code_book``) or the reference's torch-saved ``classifier.pth``: a raw
    [256, 16] tensor (train_unified_lift.py:295-297, 437), the 1×1-Conv2d
    weight [256, 16, 1, 1] it was reshaped from, or a state dict holding
    either."""
    if path.endswith(".npz"):
        return np.load(path)["code_book"].astype(np.float32)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):           # state_dict-style {'weight': ...}
        obj = next(iter(obj.values()))
    arr = np.asarray(obj.detach().float().numpy() if hasattr(obj, "detach") else obj,
                     np.float32)
    if arr.ndim == 4:                   # Conv2d weight [K, 16, 1, 1]
        arr = arr[:, :, 0, 0]
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a [num_classes, 16] codebook, got shape {arr.shape}")
    return arr


def find_codebook(model_path: str, iteration: int) -> str:
    """The codebook beside ``point_cloud/iteration_N``: ``classifier.npz``
    where it exists or where ``classifier.pth`` does not, else the reference's
    ``classifier.pth``."""
    base = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    npz = os.path.join(base, "classifier.npz")
    pth = os.path.join(base, "classifier.pth")
    return npz if os.path.exists(npz) or not os.path.exists(pth) else pth
