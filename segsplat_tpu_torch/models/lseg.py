"""LSeg (Language-driven Semantic Segmentation) in torch.nn: dense per-pixel
CLIP-space features (the counterpart of segsplat_tpu/models/lseg.py, which
replaces the reference's lang-seg submodule, script/extract_lseg_features.py).

A ViT backbone (16×16 patches, a class token, pre-LN blocks; ViT-L/16 at the
published width) with a DPT head: features tapped after blocks (5, 11, 17,
23), each read out with the class token, reassembled at four scales (×4 and ×2
by learned transposed convolutions, ×1, ×½ by a stride-2 convolution), fused
RefineNet-style with residual conv units and align-corners ×2 resizes, and a
1×1 head to 512 channels at half the input resolution.

The port works in NCHW and folds the ImageNet normalisation into the forward,
so callers feed raw [0, 1] images. ``compute_dtype`` bfloat16 keeps the
parameters in float32 and runs the products and convolutions in bfloat16
(autocast); float32 is full precision (TF32 is off in this package). The
backbone and the head run in the profiler ranges ``lseg.vit`` and
``lseg.dpt``.

The modules carry the attribute names of the public demo checkpoint
(``pretrained.model.blocks.{i}.attn.qkv``, ``pretrained.act_postprocess{t}``,
``scratch.refinenet{t}``, ...), so ``load_lseg_state_dict`` loads it as it is.
Without a checkpoint the net is initialised from a seed.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from segsplat_tpu_torch.models.clip_text import (DEFAULT_LOGIT_SCALE, strip_prefixes,
                                                 load_into, logit_scale_of,
                                                 project_features_to_labels,
                                                 self_attention)
from segsplat_tpu_torch.utils.profiling import annotate
from segsplat_tpu_torch.utils.system import require_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Attention(nn.Module):
    """timm's fused-qkv attention parameters, applied by ``self_attention``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        return self_attention(x, self.qkv.weight, self.qkv.bias, self.proj.weight,
                              self.proj.bias, self.heads)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        # exact (erf) GELU, as timm's ViT and DPT use
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)       # Flax's LayerNorm default
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpBlock(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def resize_bilinear_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] with align_corners=True endpoint mapping
    (what DPT's fusion and LSeg's output resize use, not half-pixel centres).
    LSeg resizes ×2; at an output size of 1 the JAX package's matrix averages
    the axis where this takes its first element."""
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


class FusionBlock(nn.Module):
    def __init__(self, features: int, with_skip: bool):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear_align_corners(x, 2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(x)


class Readout(nn.Module):
    """DPT's "project" readout: each patch token beside the class token,
    Linear(2W → W) and exact GELU."""

    def __init__(self, width: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * width, width), nn.GELU())

    def forward(self, tokens):                      # [B, 1+N, W] → [B, N, W]
        patches = tokens[:, 1:]
        return self.project(torch.cat([patches, tokens[:, :1].expand_as(patches)], dim=-1))


class LSegNet(nn.Module):
    """ViT backbone + DPT head: images [B, 3, H, W] in [0, 1], H and W
    multiples of 2·patch → [B, out_dim, H/2, W/2] float32 features."""

    def __init__(self, patch: int = 16, width: int = 1024, depth: int = 24, heads: int = 16,
                 taps: Sequence[int] = (5, 11, 17, 23), fusion_features: int = 256,
                 reassemble_dims: Sequence[int] = (256, 512, 1024, 1024), out_dim: int = 512,
                 image_size: int = 384, compute_dtype: torch.dtype = torch.float32,
                 norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
                 norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.patch, self.width, self.taps = patch, width, tuple(taps)
        self.grid = image_size // patch                # pos-embed grid; others resize
        self.compute_dtype = compute_dtype
        self.register_buffer("norm_mean", torch.tensor(norm_mean).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("norm_std", torch.tensor(norm_std).view(1, 3, 1, 1),
                             persistent=False)
        rd, ff = list(reassemble_dims), fusion_features

        self.pretrained = nn.Module()
        model = nn.Module()
        model.patch_embed = nn.Module()
        model.patch_embed.proj = nn.Conv2d(3, width, patch, stride=patch)
        model.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        model.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.grid ** 2, width))
        model.blocks = nn.ModuleList([ViTBlock(width, heads) for _ in range(depth)])
        self.pretrained.model = model
        for t in range(4):
            post = nn.Module()
            post.add_module("0", Readout(width))
            post.add_module("3", nn.Conv2d(width, rd[t], 1))
            if t == 0:          # ×4, a learned deconvolution (DPT act_postprocess1.4)
                post.add_module("4", nn.ConvTranspose2d(rd[0], rd[0], 4, stride=4))
            elif t == 1:        # ×2 (act_postprocess2.4)
                post.add_module("4", nn.ConvTranspose2d(rd[1], rd[1], 2, stride=2))
            elif t == 3:        # ×½ (act_postprocess4.4)
                post.add_module("4", nn.Conv2d(rd[3], rd[3], 3, stride=2, padding=1))
            setattr(self.pretrained, f"act_postprocess{t + 1}", post)

        self.scratch = nn.Module()
        for t in range(4):
            setattr(self.scratch, f"layer{t + 1}_rn",
                    nn.Conv2d(rd[t], ff, 3, padding=1, bias=False))
            setattr(self.scratch, f"refinenet{t + 1}", FusionBlock(ff, with_skip=t != 3))
        self.scratch.head1 = nn.Conv2d(ff, out_dim, 1)

    def _positions(self, gh: int, gw: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(class-token position [1, W], patch positions [gh·gw, W]); the grid is
        resized as ``jax.image.resize(..., "bilinear")`` resizes it: half-pixel
        centres, antialiased when it shrinks."""
        pos = self.pretrained.model.pos_embed[0]
        grid = pos[1:].reshape(self.grid, self.grid, self.width)
        if (gh, gw) != (self.grid, self.grid):
            grid = F.interpolate(grid.permute(2, 0, 1)[None], size=(gh, gw), mode="bilinear",
                                 align_corners=False, antialias=True)[0].permute(1, 2, 0)
        return pos[:1], grid.reshape(gh * gw, self.width)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B = images.shape[0]
        x = (images - self.norm_mean) / self.norm_std
        bf16 = self.compute_dtype == torch.bfloat16
        ctx = (torch.autocast(images.device.type, dtype=torch.bfloat16) if bf16
               else contextlib.nullcontext())
        with ctx, annotate("lseg.vit"):
            vit = self.pretrained.model
            x = vit.patch_embed.proj(x)                               # [B, W, gh, gw]
            gh, gw = x.shape[-2:]
            cls_pos, patch_pos = self._positions(gh, gw)
            x = x.flatten(2).transpose(1, 2) + patch_pos.to(x.dtype)
            cls = vit.cls_token.expand(B, 1, self.width) + cls_pos[None]
            x = torch.cat([cls.to(x.dtype), x], dim=1)
            tapped = []
            for i, blk in enumerate(vit.blocks):
                x = blk(x)
                if i in self.taps:
                    tapped.append(x)

        with ctx, annotate("lseg.dpt"):
            scales = []
            for t, tokens in enumerate(tapped):
                post = getattr(self.pretrained, f"act_postprocess{t + 1}")
                proj = getattr(post, "0")(tokens)                     # [B, N, W]
                fmap = proj.transpose(1, 2).reshape(B, self.width, gh, gw)
                fmap = getattr(post, "3")(fmap)
                if t != 2:
                    fmap = getattr(post, "4")(fmap)
                scales.append(getattr(self.scratch, f"layer{t + 1}_rn")(fmap))

            f = self.scratch.refinenet4(scales[3])
            f = self.scratch.refinenet3(f, scales[2])
            f = self.scratch.refinenet2(f, scales[1])
            f = self.scratch.refinenet1(f, scales[0])
            out = self.scratch.head1(f)                               # [B, C, H/2, W/2]
        return out.float()


def init_lseg(net: LSegNet, seed: int = 0) -> None:
    """Seeded random weights in the scale of the Flax initialisers: normal
    kernels of std 1/√fan_in (fan_in = in·kh·kw), zero biases and class token,
    unit LayerNorms, position embedding std 0.02. Drawn on the CPU, so every
    device gets the same bits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias") or name.endswith("cls_token"):
                p.zero_()
            elif ".norm" in name:
                p.fill_(1.0)
            elif name.endswith("pos_embed"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            else:
                # Linear [out, in], Conv2d [out, in, kh, kw], ConvTranspose2d [in, out, kh, kw]
                transposed = ".4.weight" in name and name.split(".")[1] in (
                    "act_postprocess1", "act_postprocess2")
                fan_in = p.shape[0 if transposed else 1] * int(np.prod(p.shape[2:]))
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))


def load_lseg_state_dict(net: LSegNet, state_dict) -> Optional[float]:
    """Load the demo checkpoint's state dict (timm ViT + DPT naming, torch or
    numpy values; leading ``module.``/``net.`` stripped, the keys the net does
    not use, such as the CLIP towers, ignored) into ``net``. Returns
    exp(logit_scale) when the dict holds it."""
    sd = strip_prefixes(state_dict, ("module.", "net."))
    load_into(net, sd, "LSeg state dict")
    return logit_scale_of(sd)


class LSegModel:
    """The net on ``device`` (the card unless the caller asks for the CPU),
    with its logit scale and scoring head."""

    def __init__(self, state_dict=None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, image_size: int = 384,
                 device: str | torch.device = "cuda", **cfg):
        self.device = require_device(device)
        self.net = LSegNet(compute_dtype=compute_dtype, image_size=image_size, **cfg)
        self.random_init = state_dict is None
        self.logit_scale = DEFAULT_LOGIT_SCALE
        if state_dict is None:
            init_lseg(self.net, seed)
        else:
            scale = load_lseg_state_dict(self.net, state_dict)
            if scale is not None:
                self.logit_scale = scale
        self.net.to(self.device).eval()

    @torch.no_grad()
    def features(self, images: torch.Tensor, upsample: bool = True) -> torch.Tensor:
        """[B, 3, H, W] → per-pixel features [B, 512, H, W] (half resolution
        without ``upsample``), float32 on the device."""
        f = self.net(torch.as_tensor(images, device=self.device))
        if upsample:
            # lseg's output_conv: Interpolate(×2, bilinear, align_corners=True)
            f = resize_bilinear_align_corners(f, 2 * f.shape[-2], 2 * f.shape[-1])
        return f

    def logits(self, features: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] features, [P, C] text → [B, H, W, P] logits."""
        return project_features_to_labels(features.movedim(1, -1), text_emb, self.logit_scale)


def pad_to_multiple(img: np.ndarray, multiple: int = 32) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad an [H, W, C] image with zeros up to a multiple of ``multiple`` (the
    reference pads to /32 before LSeg, extract_lseg_features.py:66-78).
    Returns (padded, original (H, W))."""
    h, w = img.shape[:2]
    return np.pad(img, ((0, (-h) % multiple), (0, (-w) % multiple), (0, 0))), (h, w)
