"""Plain PyTorch reference of one Unified-Lift train step and its first steps
from a point cloud: the table's initialisation, the 19-channel render (RGB from
the SH DC term at SH degree 0, the 16 identity channels), the losses (L1 and
SSIM, the ProtoNCE contrastive loss on a given pixel sample, the confidence
map, the virtual GT by a Hungarian assignment, the gated cross-entropy, the
codebook clustering, the norm regulariser), the gradients by autograd through
``raster.render`` and the two Adams. It imports nothing of the program.

The formulas follow the Unified-Lift training script as the program states
them (its OptimizationParams' rates and loss weights): each function names
what it computes. Where the program is exact and the reference free to
choose, the reference takes its own road: the 3-nearest-neighbour distances
by brute force, the assignment by SciPy's ``linear_sum_assignment``, Adam
written out.

``run`` drives ``steps`` steps from the shared inputs and returns what the
check compares: each step's total loss, each leaf's first gradient and each
leaf's change after the last step. ``resume`` takes one step from a state
that the program reached inside its window (its leaves and Adam moments,
kept by the benchmark before that step) and returns the same of that step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raster

C0 = 0.28209479177387814          # SH band-0 constant
NUM_OBJECTS = 16
NUM_CLUSTERS = 256
LEAVES = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation",
          "objects_dc", "code_book")
BETAS = (0.9, 0.999)


def knn3_mean_sq(points: torch.Tensor, k: int = 3, chunk: int = 256) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, exact (all pairs,
    in chunks of queries), summed from the nearest up."""
    n = points.shape[0]
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for q0 in range(0, n, chunk):
        q = points[q0:q0 + chunk]
        d2 = ((points[None, :, :] - q[:, None, :]) ** 2).sum(-1)          # [B, N]
        d2[torch.arange(q.shape[0]), torch.arange(q0, q0 + q.shape[0])] = math.inf
        near = torch.topk(d2, k, dim=1, largest=False).values             # ascending
        total = torch.zeros(q.shape[0], dtype=points.dtype, device=points.device)
        for j in range(k):
            total = total + near[:, j]
        out[q0:q0 + q.shape[0]] = total / k
    return out


def init_params(points: np.ndarray, colors: np.ndarray, capacity: int, sh_degree: int,
                identity_seed: int, code_book: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """The table of a point cloud: SH DC from RGB, zero higher bands, log
    scales from the 3-NN mean squared distance, identity rotation, opacity
    0.1 (as a logit), identity features (RGB→SH of U(0,1) draws from numpy's
    ``default_rng(identity_seed)``), zero rows past the points; the codebook
    as given."""
    n = points.shape[0]
    d2 = knn3_mean_sq(torch.as_tensor(points, device=device)).cpu().numpy()
    log_scale = np.log(np.sqrt(np.clip(d2, 1e-7, None)))
    ident = np.random.default_rng(identity_seed).random((n, NUM_OBJECTS))
    op0 = float(torch.log(torch.tensor(0.1) / (1 - torch.tensor(0.1))))
    rest = (sh_degree + 1) ** 2 - 1

    def rows(shape, vals=None):
        out = np.zeros((capacity,) + shape, np.float32)
        if vals is not None:
            out[:n] = np.asarray(vals, np.float32).reshape((n,) + shape)
        return torch.from_numpy(out).to(device)

    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    return {"xyz": rows((3,), points),
            "features_dc": rows((1, 3), (np.asarray(colors, np.float32) - 0.5) / C0),
            "features_rest": rows((rest, 3)),
            "opacity": rows((1,), np.full((n, 1), op0, np.float32)),
            "scaling": rows((3,), np.repeat(log_scale[:, None], 3, 1)),
            "rotation": torch.from_numpy(rot).to(device),
            "objects_dc": rows((1, NUM_OBJECTS), (ident - 0.5) / C0),
            "code_book": code_book.detach().clone().to(device)}


def render(p: Dict[str, torch.Tensor], active: torch.Tensor, cam: raster.Cam,
           bg: torch.Tensor, m: int, K: int, blend_dtype=torch.float32):
    """(RGB [3, H, W], identity [16, H, W]) of the table: colours from SH band
    0 at SH degree 0 (+0.5, clamped at 0), the identity features as they are;
    opacity sigmoid·active; scales exp; rotations normalised."""
    rgb = torch.clamp_min(C0 * p["features_dc"][:, 0, :] + 0.5, 0.0)
    payload = torch.cat([rgb, p["objects_dc"][:, 0, :]], dim=1)
    opac = torch.sigmoid(p["opacity"])[:, 0] * active.to(rgb.dtype)
    rot = p["rotation"] / (torch.linalg.norm(p["rotation"], dim=-1, keepdim=True) + 1e-12)
    bg19 = torch.cat([bg, torch.zeros(NUM_OBJECTS, device=bg.device)])
    img = raster.render(p["xyz"], torch.exp(p["scaling"]), rot, opac, payload, bg19, cam,
                        m, K, blend_dtype=blend_dtype)
    return img[..., :3].permute(2, 0, 1), img[..., 3:].permute(2, 0, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, window: int = 11, sigma: float = 1.5):
    """Mean SSIM of [C, H, W] images over a Gaussian window (σ 1.5, 11 taps,
    zero padding), C1 = 0.01², C2 = 0.03²."""
    C = x.shape[0]
    t = torch.arange(window, dtype=torch.float32, device=x.device) - window // 2
    g = torch.exp(-(t ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    kern = (g[:, None] * g[None, :]).expand(C, 1, window, window)

    def blur(z):
        return F.conv2d(z[None], kern, padding=window // 2, groups=C)[0]

    mx, my = blur(x), blur(y)
    sxx, syy, sxy = blur(x * x) - mx * mx, blur(y * y) - my * my, blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mx * my + c1) * (2 * sxy + c2))
            / ((mx * mx + my * my + c1) * (sxx + syy + c2))).mean()


def _clusters(f: torch.Tensor, lab: torch.Tensor, mult: float, lo: float, hi: float):
    """Per-cluster mean u [256, D], temperature φ [256] (detached) and count
    over the samples' labels: φ = Σ‖f − u‖ / (n·log(n + 10)), ×mult, clipped."""
    counts = torch.bincount(lab, minlength=NUM_CLUSTERS).to(f.dtype)
    sums = torch.zeros((NUM_CLUSTERS, f.shape[1]), dtype=f.dtype, device=f.device)
    sums = sums.index_add(0, lab, f)
    u = sums / torch.clamp_min(counts, 1.0)[:, None]
    dist = torch.linalg.norm(f - u[lab], dim=-1)
    num = torch.zeros(NUM_CLUSTERS, dtype=f.dtype, device=f.device).index_add(0, lab, dist)
    phi = num / torch.clamp_min(counts * torch.log(counts + 10.0), 1e-6)
    return u, torch.clamp(phi * mult, lo, hi).detach(), counts


def contrastive(features: torch.Tensor, gt_obj: torch.Tensor, idx: torch.Tensor,
                min_pixnum: int = 20):
    """(ProtoNCE over the sampled pixels, norm regulariser over all pixels)."""
    D = features.shape[0]
    feat = features.reshape(D, -1).T
    reg = ((torch.sqrt((feat * feat).sum(-1, keepdim=True) + 1e-12) - 1.0) ** 2).mean()
    f = feat[idx]
    lab = torch.clamp(gt_obj.reshape(-1)[idx], 0, NUM_CLUSTERS - 1).long()
    f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-6).detach()
    u, phi, counts = _clusters(f, lab, 10.0, 0.5, 1.0)
    valid = counts > min_pixnum
    e = torch.where(valid[None, :], torch.exp((f @ u.T) / phi[None, :]), 0.0)
    own = e.gather(1, lab[:, None])[:, 0]
    per = -torch.log(torch.clamp_min(own / (e.sum(1) + 1e-6), 1e-20)) * valid[lab]
    return per.sum() / torch.clamp_min(valid.sum(), 1), reg


def confidence(features: torch.Tensor, gt_obj: torch.Tensor, threshold: float = 0.2):
    """Binary map: a pixel's probability of its own cluster (φ·0.1 in
    [0.1, 1]) above the threshold."""
    D, H, W = features.shape
    f = features.reshape(D, -1).T
    lab = torch.clamp(gt_obj.reshape(-1), 0, NUM_CLUSTERS - 1).long()
    f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-6).detach()
    u, phi, counts = _clusters(f, lab, 0.1, 0.1, 1.0)
    e = torch.where((counts > 0)[None, :], torch.exp((f @ u.T) / phi[None, :]), 0.0)
    own = e.gather(1, lab[:, None])[:, 0]
    return ((own / (e.sum(1) + 1e-6)) > threshold).to(torch.float32).reshape(H, W)


def virtual_gt(gt_obj: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Each present mask id relabelled by the codebook class that a minimum-cost
    assignment gives it, the cost minus the id's summed softmax scores."""
    from scipy.optimize import linear_sum_assignment

    K = logits.shape[0]
    lab = torch.clamp(gt_obj.reshape(-1), 0, NUM_CLUSTERS - 1).long()
    probs = torch.softmax(logits.detach().reshape(K, -1).T, dim=-1)
    sums = torch.zeros((NUM_CLUSTERS, K), dtype=probs.dtype, device=probs.device)
    sums = sums.index_add(0, lab, probs)
    present = torch.bincount(lab, minlength=NUM_CLUSTERS) > 0
    rows = torch.nonzero(present)[:, 0]
    r, c = linear_sum_assignment(-sums[rows].double().cpu().numpy())
    assign = torch.full((NUM_CLUSTERS,), -1, dtype=torch.long)
    assign[rows.cpu()[torch.as_tensor(r)]] = torch.as_tensor(c, dtype=torch.long)
    return assign.to(gt_obj.device)[lab].reshape(gt_obj.shape)


def losses(image, objects, code_book, gt_image, gt_obj, idx, cfg: dict) -> torch.Tensor:
    """The step's total loss."""
    l1 = (image - gt_image).abs().mean()
    dssim = 1.0 - ssim(image, gt_image)
    contrast, reg = contrastive(objects, gt_obj, idx)
    conf = confidence(objects, gt_obj)
    obj = objects.detach().reshape(NUM_OBJECTS, -1)
    logits = (code_book @ obj).reshape(code_book.shape[0], *gt_obj.shape)
    vgt = virtual_gt(gt_obj, logits)
    flat = logits.reshape(logits.shape[0], -1).T
    v = vgt.reshape(-1)
    cf = conf.reshape(-1)
    ce = -torch.log_softmax(flat, dim=-1).gather(1, v[:, None])[:, 0]
    gate = (cf.sum() > 0) & (flat.argmax(-1) != v).any()
    cls = torch.where(gate, (ce * cf).sum() / torch.clamp_min(cf.sum(), 1.0), 0.0)
    cls = cls / math.log(cfg["num_classes"])
    on = obj.T / (torch.linalg.norm(obj.T, dim=-1, keepdim=True) + 1e-6)
    diff = on - code_book[v]
    d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
    clu = torch.where(cf.sum() > 0, (d * cf).sum() / torch.clamp_min(cf.sum(), 1.0), 0.0)
    w = cfg["loss_weights"]
    return ((1.0 - w["dssim"]) * l1 + w["dssim"] * dssim + w["contrastive"] * contrast
            + w["cls"] * cls + w["clustering"] * clu + w["reg"] * reg)


def xyz_lr(step: int, cfg: dict) -> float:
    """The position rate's exponential decay from init to final over
    ``position_lr_max_steps`` (no delay), times the spatial scale."""
    r = cfg["rates"]
    s = cfg["spatial_lr_scale"]
    t = min(max(step / r["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(r["position_lr_init"] * s) * (1 - t)
                    + math.log(r["position_lr_final"] * s) * t)


def leaf_rates(step: int, cfg: dict) -> Dict[str, float]:
    r = cfg["rates"]
    return {"xyz": xyz_lr(step, cfg), "features_dc": r["feature_lr"],
            "features_rest": r["feature_lr"] / 20.0, "opacity": r["opacity_lr"],
            "scaling": r["scaling_lr"], "rotation": r["rotation_lr"],
            "objects_dc": r["feature_lr"], "code_book": r["codebook_lr"]}


def adam(p: torch.Tensor, g: torch.Tensor, st: dict, lr: float, eps: float, t: int):
    """One Adam update of p in place (β 0.9, 0.999; bias-corrected)."""
    b1, b2 = BETAS
    st["m"] = b1 * st["m"] + (1 - b1) * g
    st["v"] = b2 * st["v"] + (1 - b2) * g * g
    mhat = st["m"] / (1 - b1 ** t)
    denom = torch.sqrt(st["v"]) / math.sqrt(1 - b2 ** t) + eps
    p.sub_(lr * mhat / denom)


class Stepper:
    """The reference's training state from the shared inputs and its step:
    ``inputs`` points, colors (numpy), identity_seed, code_book; ``feed(i)`` →
    (R, gt_image, gt_obj, idx) for step i; the blend in ``blend_dtype``.
    ``start``, when given, is a state to go on from instead of the
    initialisation: {"params", "m", "v": {leaf: tensor}, "t": steps done}."""

    def __init__(self, inputs: dict, cfg: dict, feed, blend_dtype=torch.float32,
                 start: Optional[dict] = None):
        raster.no_tf32()
        self.cfg, self.feed, self.blend_dtype = cfg, feed, blend_dtype
        self.dev = inputs["code_book"].device
        self.active = torch.arange(cfg["capacity"], device=self.dev) < inputs["points"].shape[0]
        if start is None:
            self.p = init_params(inputs["points"], inputs["colors"], cfg["capacity"],
                                 cfg["sh_degree"], inputs["identity_seed"],
                                 inputs["code_book"], self.dev)
            self.state = {k: {"m": torch.zeros_like(v), "v": torch.zeros_like(v)}
                          for k, v in self.p.items()}
            self.t = 0
        else:
            self.p = {k: start["params"][k].detach().clone() for k in LEAVES}
            self.state = {k: {"m": start["m"][k].clone(), "v": start["v"][k].clone()}
                          for k in LEAVES}
            self.t = int(start["t"])
        self.grads: Dict[str, torch.Tensor] = {}

    def step(self, i: int) -> dict:
        """Step i; returns {"total": the loss} and leaves the gradients in
        ``self.grads``."""
        cfg = self.cfg
        R, gt_image, gt_obj, idx = self.feed(i)
        cam = raster.pinhole(R, torch.zeros(3, device=self.dev), cfg["fov_x"], cfg["fov_y"],
                             cfg["width"], cfg["height"])
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.p.items()}
        image, objects = render(leaves, self.active, cam, torch.zeros(3, device=self.dev),
                                cfg["max_tiles_per_axis"], cfg["max_per_tile"], self.blend_dtype)
        total = losses(image, objects, leaves["code_book"], gt_image, gt_obj, idx, cfg)
        grads = torch.autograd.grad(total, [leaves[k] for k in LEAVES], allow_unused=True)
        rates = leaf_rates(self.t, cfg)
        self.t += 1
        for k, g in zip(LEAVES, grads):
            g = torch.zeros_like(self.p[k]) if g is None else g
            self.grads[k] = g
            eps = cfg["adam_eps"]["code_book" if k == "code_book" else "table"]
            adam(self.p[k], g, self.state[k], rates[k], eps, self.t)
        return {"total": total.detach()}


def run(inputs: dict, cfg: dict, steps: int = 3, blend_dtype=torch.float32,
        feed=None) -> dict:
    """``steps`` steps of a ``Stepper``. Returns {"loss": [float]·steps,
    "grad1": {leaf: ‖g‖ of step 1}, "change": {leaf: ‖Δ‖ after the last}}."""
    st = Stepper(inputs, cfg, feed, blend_dtype)
    start = {k: v.clone() for k, v in st.p.items()}
    out = {"loss": [], "grad1": {}, "change": {}}
    for i in range(steps):
        out["loss"].append(float(st.step(i)["total"]))
        if i == 0:
            out["grad1"] = {k: float(torch.linalg.norm(st.state[k]["m"].double()))
                            / (1 - BETAS[0]) for k in LEAVES}
    out["change"] = {k: float(torch.linalg.norm((st.p[k] - start[k]).double()))
                     for k in LEAVES}
    return out


def resume(inputs: dict, cfg: dict, start: dict, feed, blend_dtype=torch.float32) -> dict:
    """Step ``start["t"]`` from the state ``start`` (see ``Stepper``). Returns
    {"loss": [float], "grad1": {leaf: ‖g‖}, "change": {leaf: ‖Δ‖}}."""
    st = Stepper(inputs, cfg, feed, blend_dtype, start=start)
    loss = float(st.step(st.t)["total"])
    return {"loss": [loss],
            "grad1": {k: float(torch.linalg.norm(st.grads[k].double())) for k in LEAVES},
            "change": {k: float(torch.linalg.norm((st.p[k] - start["params"][k]).double()))
                       for k in LEAVES}}
