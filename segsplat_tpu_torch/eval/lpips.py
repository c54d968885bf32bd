"""LPIPS perceptual metric (net-lin), the counterpart of
segsplat_tpu/eval/lpips.py, after the reference's vendored
PerceptualSimilarity (lama/saicinpainting/evaluation/losses/lpips.py: PNetLin
:533-600, ScalingLayer :603-610, NetLinLayer :613-622, the vgg16 slices
:817-860 and alexnet :767-806, normalize_tensor :45-47, spatial_average
:521-522), version 0.1, lpips=True, spatial=False:

  inputs in [0, 1] → [-1, 1] → ScalingLayer → backbone slices → per-layer
  unit-normalised channels → squared difference → 1×1 lin weights → spatial
  mean → sum over the layers.

The parameters are numpy, in the JAX package's layout (HWIO convs, a [C] lin
vector per layer), and built by the same functions: ``init_backbone`` (the
deterministic He-initialised backbone used when no converted torchvision
checkpoint is given, stamped ``backbone="random(seed0)"``), the two
checkpoint converters and ``load_lpips`` (the lin weights of a converted
checkpoint the caller names, else uniform 1/C, stamped ``"none"``). A score
over a random backbone is a relative texture-similarity instrument, not
canonical LPIPS, and every consumer surfaces the stamps.

``LPIPS`` is the network as an NCHW ``nn.Module`` (``nn.Conv2d`` and
``nn.MaxPool2d`` slices); ``lpips`` scores images on a device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from segsplat_tpu_torch.utils.system import require_device

# ScalingLayer buffers (lpips.py:606-607)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 features: 3×3 convs, pad 1, and 2×2 max pools between the blocks;
# the slices end after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (conv 1, 3,
# 6, 9, 12)
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_VGG_TAPS = (1, 3, 6, 9, 12)
_VGG_LINS = (64, 128, 256, 512, 512)

# AlexNet features: (out, k, stride, pad), "M" = 3×3 max pool, stride 2; a tap
# after every conv's relu
_ALEX_CFG: List = [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M",
                   (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_TAPS = (0, 1, 2, 3, 4)
_ALEX_LINS = (64, 192, 384, 256, 256)

def _conv_shapes(net: str) -> List[Tuple[int, int, int, int, int]]:
    """[(in_ch, out_ch, k, stride, pad)] for every conv in ``net``'s features."""
    out = []
    c_in = 3
    if net == "vgg":
        for v in _VGG_CFG:
            if v == "M":
                continue
            out.append((c_in, v, 3, 1, 1))
            c_in = v
    elif net == "alex":
        for v in _ALEX_CFG:
            if v == "M":
                continue
            o, k, s, p = v
            out.append((c_in, o, k, s, p))
            c_in = o
    else:
        raise ValueError(f"net must be 'vgg' or 'alex', got {net!r}")
    return out


def init_backbone(net: str = "vgg", seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic He-initialised backbone (numpy ``default_rng(seed)``, the
    JAX package's draws). Weights are HWIO."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for i, (ci, co, k, _s, _p) in enumerate(_conv_shapes(net)):
        fan_in = ci * k * k
        params[f"conv{i}_w"] = (rng.standard_normal((k, k, ci, co))
                                * np.sqrt(2.0 / fan_in)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros(co, np.float32)
    return params


def convert_backbone_checkpoint(state_dict: Dict[str, np.ndarray],
                                net: str = "vgg") -> Dict[str, np.ndarray]:
    """torchvision ``features.*.{weight,bias}`` (OIHW) → the HWIO conv dict.
    Takes torchvision's index keys or the dict's own ``conv{i}_{w,b}`` keys."""
    shapes = _conv_shapes(net)
    tv_idx = ([0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28] if net == "vgg"
              else [0, 3, 6, 8, 10])
    params = {}
    for i, ((ci, co, k, _s, _p), ti) in enumerate(zip(shapes, tv_idx)):
        for cand in (f"features.{ti}.weight", f"conv{i}_w"):
            if cand in state_dict:
                w = np.asarray(state_dict[cand], np.float32)
                break
        else:
            raise KeyError(f"missing conv {i} (features.{ti}.weight)")
        if w.shape != (co, ci, k, k):
            raise ValueError(f"conv {i}: expected {(co, ci, k, k)}, got {w.shape}")
        params[f"conv{i}_w"] = w.transpose(2, 3, 1, 0)      # OIHW → HWIO
        for cand in (f"features.{ti}.bias", f"conv{i}_b"):
            if cand in state_dict:
                params[f"conv{i}_b"] = np.asarray(state_dict[cand], np.float32)
                break
        else:
            raise KeyError(f"missing conv {i} bias")
    return params


def convert_lpips_checkpoint(state_dict, net: str = "vgg") -> List[np.ndarray]:
    """The reference's lpips_models/{net}.pth (``lin{k}.model.1.weight``
    [1, C, 1, 1]) → a list of [C] calibration vectors."""
    lins_c = _VGG_LINS if net == "vgg" else _ALEX_LINS
    out = []
    for k, c in enumerate(lins_c):
        w = np.asarray(state_dict[f"lin{k}.model.1.weight"], np.float32)
        if w.shape != (1, c, 1, 1):
            raise ValueError(f"lin{k}: expected (1,{c},1,1), got {w.shape}")
        out.append(w.reshape(c))
    return out


def load_lpips(net: str = "vgg", lin_path: Optional[str] = None,
               backbone_path: Optional[str] = None, seed: int = 0) -> dict:
    """LPIPS parameters: ``{"net", "backbone", "lins", "backbone_source",
    "lin_source"}``. Without a readable ``lin_path`` (the reference's
    lpips_models/{net}.pth, or an .npz of ``lin{k}``) the lins are uniform 1/C,
    stamped ``"none"``; nothing outside the caller's paths is read. Without a
    converted ``backbone_path`` (.npz) the seeded random backbone is used and
    stamped."""
    lin_source = "none"
    if lin_path and os.path.exists(lin_path):
        if lin_path.endswith(".npz"):
            d = np.load(lin_path)
            lins = [d[f"lin{k}"] for k in range(len(_VGG_LINS if net == "vgg"
                                                    else _ALEX_LINS))]
        else:
            sd = torch.load(lin_path, map_location="cpu")
            lins = convert_lpips_checkpoint({k: v.numpy() for k, v in sd.items()}, net)
        lin_source = f"checkpoint:{os.path.basename(lin_path)}"
    else:
        lins = [np.ones(c, np.float32) / c for c in (_VGG_LINS if net == "vgg" else _ALEX_LINS)]
    if backbone_path and os.path.exists(backbone_path):
        backbone = convert_backbone_checkpoint(dict(np.load(backbone_path)), net)
        backbone_source = f"checkpoint:{os.path.basename(backbone_path)}"
    else:
        backbone = init_backbone(net, seed)
        backbone_source = f"random(seed{seed})"
    return {"net": net, "backbone": backbone, "lins": lins,
            "backbone_source": backbone_source, "lin_source": lin_source}


class LPIPS(nn.Module):
    """The LPIPS network in NCHW: torchvision's ``features`` cut into slices at
    the taps, the ScalingLayer buffers and the lin weights as buffers."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        self.net = net
        cfg = _VGG_CFG if net == "vgg" else _ALEX_CFG
        taps = set(_VGG_TAPS if net == "vgg" else _ALEX_TAPS)
        pool = (2, 2) if net == "vgg" else (3, 2)
        shapes = iter(_conv_shapes(net))
        slices, layers, ci = [], [], 0
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(*pool))
                continue
            c_in, c_out, k, s, p = next(shapes)
            layers += [nn.Conv2d(c_in, c_out, k, stride=s, padding=p), nn.ReLU()]
            if ci in taps:
                slices.append(nn.Sequential(*layers))
                layers = []
            ci += 1
        self.slices = nn.ModuleList(slices)
        lins = _VGG_LINS if net == "vgg" else _ALEX_LINS
        for k, c in enumerate(lins):
            self.register_buffer(f"lin{k}", torch.zeros(c))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1))

    def convs(self) -> List[nn.Conv2d]:
        return [m for s in self.slices for m in s if isinstance(m, nn.Conv2d)]

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for s in self.slices:
            x = s(x)
            taps.append(x)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        """img* [N, 3, H, W] in [0, 1] (``normalize``) or [-1, 1] → [N]."""
        if normalize:
            img0, img1 = 2.0 * img0 - 1.0, 2.0 * img1 - 1.0
        f0 = self.features((img0 - self.shift) / self.scale)
        f1 = self.features((img1 - self.shift) / self.scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            na = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + 1e-10)
            d = (na - nb) ** 2
            lin = getattr(self, f"lin{k}")
            total = total + torch.einsum("nchw,c->nhw", d, lin).mean(dim=(1, 2))
        return total


@torch.no_grad()
def lpips(img0, img1, params, normalize: bool = True,
          device: str | torch.device = "cuda"):
    """LPIPS distance per batch item on ``device``: img* [N, H, W, 3] (or
    [H, W, 3]) float in [0, 1] (``normalize``, the evaluator's convention) or
    [-1, 1], numpy or tensors. ``params`` is ``load_lpips``'s dict, or, to
    score many images without rebuilding the network, the ``LPIPS`` module
    ``convert.lpips_from_params`` made of it. A float for one image (a 3-D
    input or a batch of one), else a numpy [N]."""
    device = require_device(device)
    if not isinstance(params, LPIPS):
        from segsplat_tpu_torch.convert import lpips_from_params

        params = lpips_from_params(params)
    model = params.to(device).eval()
    a = torch.as_tensor(np.asarray(img0, np.float32) if not torch.is_tensor(img0) else img0,
                        dtype=torch.float32, device=device)
    b = torch.as_tensor(np.asarray(img1, np.float32) if not torch.is_tensor(img1) else img1,
                        dtype=torch.float32, device=device)
    squeeze = a.ndim == 3
    if squeeze:
        a, b = a[None], b[None]
    out = model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2),
                                 normalize=normalize).cpu().numpy()
    return float(out[0]) if (squeeze or out.shape == (1,)) else out
