"""Unified-Lift training losses (the counterpart of segsplat_tpu/train/losses.py,
after the reference's train_unified_lift.py and utils/loss_utils.py):

  * photometric L1 + windowed SSIM (σ = 1.5, window 11, separable depthwise
    blur as ``F.conv2d(groups=C)``),
  * ProtoNCE contrastive loss over the 16-D identity features with a
    per-cluster temperature φ,
  * the binary confidence map,
  * virtual-GT relabelling by Hungarian assignment of codebook scores to mask
    ids — the [256, 256] cost is solved on the host (ops/assignment.py),
  * the confidence-gated cross-entropy and the codebook clustering loss,
  * the kNN-KL 3-D regulariser ``loss_cls_3d``, on no train step (as in the
    JAX package).

Every cluster statistic is a fixed-width (NUM_CLUSTERS = 256) reduction through
a one-hot matrix, as in the JAX package. Random draws come from a
``torch.Generator``; each function that draws also takes the draw itself
(``idx=``), so a test can feed it the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from segsplat_tpu_torch.ops.assignment import linear_sum_assignment

NUM_CLUSTERS = 256


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean windowed SSIM of [C, H, W] images, C1 = 0.01², C2 = 0.03²."""
    C = img1.shape[0]
    x1d = torch.arange(window_size, dtype=torch.float32, device=img1.device) - window_size // 2
    g1d = torch.exp(-(x1d ** 2) / (2 * sigma ** 2))
    g1d = g1d / g1d.sum()
    kh = g1d.reshape(1, 1, 1, window_size).expand(C, 1, 1, window_size)
    kv = g1d.reshape(1, 1, window_size, 1).expand(C, 1, window_size, 1)
    half = window_size // 2

    def blur(x):
        y = F.conv2d(x[None], kh, padding=(0, half), groups=C)
        return F.conv2d(y, kv, padding=(half, 0), groups=C)[0]

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = ((pred - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))


def _label_onehot(labels: torch.Tensor) -> torch.Tensor:
    """[S] int → [S, NUM_CLUSTERS] float32 one-hot."""
    return F.one_hot(labels.long(), NUM_CLUSTERS).to(torch.float32)


def _cluster_stats(feat_n: torch.Tensor, labels: torch.Tensor, phi_mult: float,
                   phi_min: float, phi_max: float,
                   onehot: Optional[torch.Tensor] = None):
    """Per-cluster mean direction u [K, D], temperature φ [K] (no gradient) and
    counts [K] over NUM_CLUSTERS segments of normalised features [S, D]."""
    oh = _label_onehot(labels) if onehot is None else onehot      # [S, K]
    counts = oh.sum(dim=0)
    sums = oh.T @ feat_n                                           # [K, D]
    u = sums / torch.clamp_min(counts, 1.0)[:, None]
    # φ_k = Σ‖f−u‖ / (n_k · log(n_k+10))   (train_unified_lift.py:197)
    dist_to_u = torch.linalg.norm(feat_n - u[labels.long()], dim=-1)
    phi_num = (oh.T @ dist_to_u[:, None])[:, 0]
    phi = phi_num / torch.clamp_min(counts * torch.log(counts + 10.0), 1e-6)
    phi = torch.clamp(phi * phi_mult, phi_min, phi_max)
    return u, phi.detach(), counts


def contrastive_loss(features: torch.Tensor, gt_obj: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     idx: Optional[torch.Tensor] = None, batch_size: int = 32768,
                     min_pixnum: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ProtoNCE, norm regularisation) over rendered identity features
    [D, H, W] and mask ids [H, W]: ``batch_size`` sampled pixels (``idx``, or
    drawn from ``generator``), clustered by mask id, φ·10 clipped to [0.5, 1]."""
    D = features.shape[0]
    feat = features.reshape(D, -1).T                               # [P, D]
    # safe norm: background pixels render exactly-zero features
    reg = ((torch.sqrt((feat * feat).sum(-1, keepdim=True) + 1e-12) - 1.0) ** 2).mean()

    P = feat.shape[0]
    if idx is None:
        idx = torch.randint(0, P, (batch_size,), generator=generator, device=feat.device)
    f = feat[idx]
    lab = torch.clamp(gt_obj.reshape(-1)[idx], 0, NUM_CLUSTERS - 1).long()
    f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-6).detach()

    u, phi, counts = _cluster_stats(f, lab, 10.0, 0.5, 1.0)
    valid = counts > min_pixnum                                    # [K]
    logits = (f @ u.T) / phi[None, :]                              # [S, K]
    e = torch.where(valid[None, :], torch.exp(logits), 0.0)
    own = torch.gather(e, 1, lab[:, None])[:, 0]
    denom = e.sum(dim=1) + 1e-6
    per_sample = -torch.log(torch.clamp_min(own / denom, 1e-20)) * valid[lab]
    cnum = torch.clamp_min(valid.sum(), 1)
    return per_sample.sum() / cnum, reg


def confidence_map(features: torch.Tensor, gt_obj: torch.Tensor, threshold: float = 0.2,
                   onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[H, W] binary confidence: each pixel's probability of its own cluster
    under φ·0.1 ∈ [0.1, 1], thresholded."""
    D, H, W = features.shape
    feat = features.reshape(D, -1).T
    lab = torch.clamp(gt_obj.reshape(-1), 0, NUM_CLUSTERS - 1).long()
    f = feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-6).detach()
    u, phi, counts = _cluster_stats(f, lab, 0.1, 0.1, 1.0, onehot=onehot)
    valid = counts > 0
    logits = (f @ u.T) / phi[None, :]
    e = torch.where(valid[None, :], torch.exp(logits), 0.0)
    own = torch.gather(e, 1, lab[:, None])[:, 0]
    conf = own / (e.sum(dim=1) + 1e-6)
    return (conf > threshold).to(torch.float32).reshape(H, W)


def virtual_gt_labels(gt_obj: torch.Tensor, logits: torch.Tensor,
                      onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hungarian-matched relabelling [H, W] of the mask ids gt_obj [H, W] by the
    codebook scores logits [K, H, W]: the [K, K] cost is minus the per-id sums
    of softmax scores (rows of absent ids 0), solved on the host for the
    present ids only. No gradient flows through it."""
    K = logits.shape[0]
    lab = torch.clamp(gt_obj.reshape(-1), 0, NUM_CLUSTERS - 1).long()
    probs = torch.softmax(logits.detach().reshape(K, -1).T, dim=-1)   # [P, K]
    oh = _label_onehot(lab) if onehot is None else onehot
    counts = oh.sum(dim=0)
    sums = oh.T @ probs                                                # [K, K]
    present = counts > 0
    cost = torch.where(present[:, None], -sums, 0.0)
    # one host sync per step: the fetched cost and present mask
    assign, _ = linear_sum_assignment(cost.cpu().numpy(), row_mask=present.cpu().numpy())
    assign = torch.as_tensor(assign, device=gt_obj.device).long()
    return assign[lab].reshape(gt_obj.shape)


def gated_classification_loss(logits: torch.Tensor, vgt: torch.Tensor,
                              confidence: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Confidence-gated cross-entropy against the virtual GT, over
    log(num_classes); zero when predictions already match everywhere or no
    pixel is confident."""
    K = logits.shape[0]
    flat_logits = logits.reshape(K, -1).T
    flat_vgt = vgt.reshape(-1).long()
    flat_conf = confidence.reshape(-1)
    ce = -torch.gather(torch.log_softmax(flat_logits, dim=-1), 1, flat_vgt[:, None])[:, 0]
    conf_sum = flat_conf.sum()
    loss = (ce * flat_conf).sum() / torch.clamp_min(conf_sum, 1.0)
    any_mismatch = (flat_logits.argmax(dim=-1) != flat_vgt).any()
    gate = (conf_sum > 0) & any_mismatch
    return torch.where(gate, loss, 0.0) / math.log(num_classes)


def clustering_loss(objects: torch.Tensor, vgt: torch.Tensor, code_book: torch.Tensor,
                    confidence: torch.Tensor) -> torch.Tensor:
    """Pull the normalised, detached identity features toward their assigned
    codebook row on confident pixels."""
    D = objects.shape[0]
    obj = objects.detach().reshape(D, -1).T
    obj = obj / (torch.linalg.norm(obj, dim=-1, keepdim=True) + 1e-6)
    cb = code_book[vgt.reshape(-1).long()]
    conf = confidence.reshape(-1)
    diff = obj - cb
    d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
    return torch.where(conf.sum() > 0,
                       (d * conf).sum() / torch.clamp_min(conf.sum(), 1.0), 0.0)


def loss_cls_3d(features: torch.Tensor, predictions: torch.Tensor,
                generator: Optional[torch.Generator] = None, k: int = 5,
                lambda_val: float = 2.0, max_points: int = 300000,
                sample_size: int = 1000) -> torch.Tensor:
    """kNN-KL spatial consistency over Gaussian class probabilities
    (utils/loss_utils.py:75-115), with fixed-size sampling: at most
    ``max_points`` Gaussians kept, ``sample_size`` of them drawn without
    replacement from ``generator``. On no train step, as in the JAX package.
    The draws are ``loss_cls_3d_at``'s ``keep`` and ``idx``."""
    n = features.shape[0]
    dev = features.device
    keep = None
    if n > max_points:
        keep = torch.randperm(n, generator=generator, device="cpu")[:max_points].to(dev)
        n = max_points
    idx = torch.randperm(n, generator=generator, device="cpu")[:sample_size].to(dev)
    return loss_cls_3d_at(features, predictions, keep, idx, k, lambda_val)


def loss_cls_3d_at(features: torch.Tensor, predictions: torch.Tensor,
                   keep: Optional[torch.Tensor], idx: torch.Tensor, k: int = 5,
                   lambda_val: float = 2.0) -> torch.Tensor:
    """``loss_cls_3d`` at given draws: ``keep`` the Gaussians kept (None: all),
    ``idx`` the sampled rows among them. Each sample's k nearest kept
    Gaussians (squared distance by the expansion |s|² − 2 s·f + |f|², itself
    among them) give KL(p_sample ‖ p_neighbour), summed over classes, averaged
    over samples and neighbours and divided by the class count."""
    if keep is not None:
        features, predictions = features[keep], predictions[keep]
    sf, sp = features[idx], predictions[idx]
    d = ((sf ** 2).sum(1)[:, None] - 2 * sf @ features.T
         + (features ** 2).sum(1)[None])
    nbr = torch.topk(-d, k, dim=1).indices
    nbr_p = predictions[nbr]                                    # [S, k, C]
    kl = sp[:, None] * (torch.log(sp[:, None] + 1e-10) - torch.log(nbr_p + 1e-10))
    loss = kl.sum(-1).mean() / predictions.shape[1]
    return lambda_val * loss
