"""The CLIP text encoder in torch.nn: the text tower behind LSeg's
open-vocabulary head (the counterpart of segsplat_tpu/models/clip_text.py).

LSeg scores 512-D pixel and voxel features against CLIP ViT-B/32 text
embeddings (the reference's voxeltoGaussian_logits.py:189-199 calls lang-seg's
``project_features_to_labels``). The text model is the public CLIP
architecture: a causal transformer of width 512, 12 layers and 8 heads over a
context of 77 tokens, a final LayerNorm, a 512-D text projection and a learned
logit scale.

The modules carry the attribute names of the OpenAI CLIP checkpoint
(``token_embedding``, ``transformer.resblocks.{i}.attn.in_proj_weight``, ...),
so ``load_clip_text_state_dict`` loads such a state dict as it is. Without
weights the tower is initialised from a seed and marks itself ``random_init``:
its embeddings then carry no meaning.

The arithmetic follows the Flax modules: LayerNorm with eps 1e-5, attention
written out as (q / √d) @ kᵀ, the causal mask filled with the dtype's minimum,
softmax and @ v, all in float32; the embedding is read at the EOT token, the
position of the largest token id.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from segsplat_tpu_torch.models.tokenizer import CONTEXT_LENGTH, VOCAB_SIZE, get_tokenizer
from segsplat_tpu_torch.utils.system import require_device

DEFAULT_LOGIT_SCALE = float(np.float32(np.exp(np.log(1 / 0.07))))


def self_attention(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                   w_out: torch.Tensor, b_out: torch.Tensor, heads: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention of x [B, T, W] with the q|k|v rows packed in
    ``w_qkv`` [3W, W] (as torch's in_proj and timm's qkv pack them), as Flax's
    MultiHeadDotProductAttention computes it: the query divided by √head_dim
    before the product, entries where ``mask`` [T, T] is False set to the
    dtype's minimum, softmax in float32."""
    B, T, W = x.shape
    hd = W // heads
    q, k, v = F.linear(x, w_qkv, b_qkv).view(B, T, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = q / torch.tensor(math.sqrt(hd), dtype=q.dtype, device=q.device)
    s = q @ k.transpose(-1, -2)                                   # [B, heads, T, T]
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    o = (p @ v).transpose(1, 2).reshape(B, T, W)
    return F.linear(o, w_out, b_out)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    """The CLIP checkpoint's nn.MultiheadAttention parameters, applied by
    ``self_attention``."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask=None):
        return self_attention(x, self.in_proj_weight, self.in_proj_bias,
                              self.out_proj.weight, self.out_proj.bias, self.heads, mask)


class ClipMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.gelu = QuickGELU()
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(self.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = ClipAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = ClipMlp(width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class ClipTextEncoder(nn.Module):
    """Causal text transformer: tokens [P, T] → [P, embed_dim] text features
    (not normalised)."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: int = 512, vocab_size: int = VOCAB_SIZE,
                 context_length: int = CONTEXT_LENGTH):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads) for _ in range(layers)])
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        P, T = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[None, :T]
        causal = torch.ones((T, T), dtype=torch.bool, device=tokens.device).tril()
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        x = x[torch.arange(P, device=tokens.device), tokens.argmax(dim=1)]
        return x @ self.text_projection


def init_clip_text(model: ClipTextEncoder, seed: int = 0) -> None:
    """Seeded random weights in the scale of the Flax initialisers: normal
    kernels of std 1/√fan_in, zero biases, unit LayerNorms, position embedding
    std 0.01, text projection std 0.02. Drawn on the CPU, so every device gets
    the same bits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                std = {"positional_embedding": 0.01, "text_projection": 0.02,
                       "token_embedding.weight": 1.0 / math.sqrt(p.shape[0])}.get(
                    name, 1.0 / math.sqrt(p.shape[1]))
                p.copy_(torch.randn(p.shape, generator=gen) * std)


def strip_prefixes(state_dict, prefixes) -> Dict[str, torch.Tensor]:
    """Keys without their LEADING wrapper prefixes, values as CPU tensors."""
    out = {}
    for k, v in state_dict.items():
        for pre in prefixes:
            while k.startswith(pre):
                k = k[len(pre):]
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
    return out


def load_into(model: nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    """Load the model's own keys from ``sd``, ignoring the rest (a checkpoint
    holds other towers too); raises naming the keys it lacks, and on a shape
    that differs from the model's."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{what} lacks {len(missing)} keys of the model, e.g. {missing[:5]}")
    model.load_state_dict({k: sd[k].to(own[k].dtype) for k in own})


def logit_scale_of(sd: Dict[str, torch.Tensor]) -> Optional[float]:
    """exp of a checkpoint's LOG logit scale, whatever its shape (0-d or (1,)),
    or None when it holds none."""
    if "logit_scale" not in sd:
        return None
    return float(np.exp(np.asarray(sd["logit_scale"], np.float32).reshape(())))


def load_clip_text_state_dict(model: ClipTextEncoder, state_dict) -> Optional[float]:
    """Load an OpenAI CLIP state dict (torch or numpy values; the leading
    ``module.``/``net.``/``clip_pretrained.`` prefixes of DDP and of LSeg's
    Lightning checkpoint are stripped, the visual tower's keys ignored) into
    ``model``. Returns exp(logit_scale) when the dict holds it."""
    sd = strip_prefixes(state_dict, ("module.", "net.", "clip_pretrained."))
    load_into(model, sd, "CLIP text state dict")
    return logit_scale_of(sd)


class TextTower:
    """Tokenizer + encoder + logit scale on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, state_dict=None, config: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = require_device(device)
        self.model = ClipTextEncoder(**(config or {}))
        self.random_init = state_dict is None   # no converted weights: embeddings
        #                                         are NOT semantically meaningful
        self.logit_scale = DEFAULT_LOGIT_SCALE
        if state_dict is None:
            init_clip_text(self.model, seed)
        else:
            scale = load_clip_text_state_dict(self.model, state_dict)
            if scale is not None:
                self.logit_scale = scale
        self.model.to(self.device).eval()

    @torch.no_grad()
    def encode(self, tokens) -> torch.Tensor:
        """[P, 77] token ids → [P, D] L2-normalised text embeddings on the device."""
        emb = self.model(torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                         device=self.device))
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)

    def encode_prompts(self, prompts, tokenizer=None) -> np.ndarray:
        """Prompt strings → [P, D] normalised embeddings, the interface
        pipeline/query's ``text_model`` expects."""
        tokenizer = tokenizer or get_tokenizer()
        return self.encode(tokenizer(list(prompts))).cpu().numpy()


def project_features_to_labels(features: torch.Tensor, text_emb: torch.Tensor,
                               logit_scale) -> torch.Tensor:
    """Open-vocabulary scoring head: logits = s · norm(feat) @ textᵀ.

    features [..., C], text_emb [P, C] already normalised → [..., P], one
    product over the whole table (the reference scores 10k-voxel batches)."""
    f = features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + 1e-12)
    return logit_scale * (f @ text_emb.T)
