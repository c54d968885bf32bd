"""Carry Gaussian weights and training state from the JAX package into the port.

``table_from_jax_arrays`` takes the numpy form of a JAX ``GaussianTable`` (every
field, e.g. ``{f.name: np.asarray(getattr(t, f.name)) for f in
dataclasses.fields(t)}``) and builds the port's table, so that both packages
compute on the same weights. ``train_state_from_jax_arrays`` takes the numpy
form of a JAX ``TrainState`` (``jax.tree.map(np.asarray, state)``: the same
NamedTuples and dataclasses with numpy leaves) and builds the port's train
state with optax's Adam moments, so that both packages take a step from the
same state. ``clip_text_from_flax`` and ``lseg_from_flax`` take the Flax
parameter trees of the JAX ``ClipTextEncoder`` and ``LSegNet`` with numpy
leaves (``jax.tree.map(np.asarray, params)``) and return the port's state
dicts, in the public checkpoints' namespaces. Nothing here imports JAX, Flax
or optax: the state is read by attribute names and dict keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from segsplat_tpu_torch.core.types import GaussianTable
from segsplat_tpu_torch.train.densify import DensifyStats
from segsplat_tpu_torch.train.trainer import (GROUP_OF_FIELD, OptimizationConfig,
                                              TrainState, init_state)
from segsplat_tpu_torch.utils.system import require_device

_TENSOR_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                  "opacity", "objects_dc")


def table_from_jax_arrays(fields: Dict[str, np.ndarray],
                          device: str | torch.device = "cuda") -> GaussianTable:
    """numpy fields of a JAX GaussianTable → the port's GaussianTable on
    ``device``. Raises KeyError naming a missing field."""
    device = require_device(device)
    missing = [k for k in _TENSOR_FIELDS + ("active", "active_sh_degree",
                                            "max_sh_degree") if k not in fields]
    if missing:
        raise KeyError(f"JAX GaussianTable fields missing: {missing}")
    tensors = {k: torch.from_numpy(np.asarray(fields[k], np.float32).copy()).to(device)
               for k in _TENSOR_FIELDS}
    return GaussianTable(
        **tensors,
        active=torch.from_numpy(np.asarray(fields["active"], bool).copy()).to(device),
        active_sh_degree=int(fields["active_sh_degree"]),
        max_sh_degree=int(fields["max_sh_degree"]))


def _adam_state(mu: np.ndarray, nu: np.ndarray, count: int, device) -> dict:
    """torch.optim.Adam's per-parameter state from optax's moments and count."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    return {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": t(mu), "exp_avg_sq": t(nu)}


def train_state_from_jax_arrays(state: Any, cfg: OptimizationConfig,
                                spatial_lr_scale: float,
                                device: str | torch.device = "cuda") -> TrainState:
    """The numpy form of a JAX ``TrainState`` → the port's ``TrainState`` on
    ``device``: table, codebook, densify stats and step, and the Adam ``mu``,
    ``nu`` and count of every table field (read from optax's
    ``multi_transform`` state, label by label) and of the codebook."""
    device = require_device(device)
    jt = state.table
    fields = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)}
    table = table_from_jax_arrays(fields, device=device)
    code_book = torch.from_numpy(np.asarray(state.code_book, np.float32).copy()).to(device)
    out = init_state(table, cfg, spatial_lr_scale, code_book=code_book)
    out.stats = DensifyStats(*(torch.from_numpy(np.asarray(x, np.float32).copy()).to(device)
                               for x in (state.stats.grad_accum, state.stats.denom,
                                         state.stats.max_radii)))
    out.step = int(state.step)
    for field, label in GROUP_OF_FIELD.items():
        adam = state.opt_state.inner_states[label].inner_state[0]
        out.gauss_opt.state[getattr(table, field)] = _adam_state(
            adam.mu[field], adam.nu[field], int(adam.count), device)
    adam = state.cls_opt_state[0]
    out.cls_opt.state[out.code_book] = _adam_state(adam.mu, adam.nu, int(adam.count),
                                                   device)
    return out


# ───────────────────── the CLIP text tower and LSeg, from Flax ─────────────────────

def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(p) -> tuple:
    """A Flax Dense {kernel [in, out], bias} → (torch weight [out, in], bias)."""
    return np.asarray(p["kernel"]).T, np.asarray(p["bias"])


def _attention(p, width: int) -> tuple:
    """Flax MultiHeadDotProductAttention params (query/key/value kernels
    [in, heads, head_dim], out kernel [heads, head_dim, out]) → the packed
    q|k|v weight [3W, W] and bias [3W], and the out weight [W, W] and bias."""
    w_qkv = np.concatenate([np.asarray(p[n]["kernel"]).reshape(width, -1).T
                            for n in ("query", "key", "value")])
    b_qkv = np.concatenate([np.asarray(p[n]["bias"]).reshape(-1)
                            for n in ("query", "key", "value")])
    return w_qkv, b_qkv, np.asarray(p["out"]["kernel"]).reshape(-1, width).T, p["out"]["bias"]


def _conv(p, transpose: bool = False) -> tuple:
    """A Flax Conv kernel [kh, kw, in, out] → torch Conv2d [out, in, kh, kw]; a
    ConvTranspose(transpose_kernel=True) kernel [kh, kw, out, in] → torch
    ConvTranspose2d [in, out, kh, kw]: the same axis permutation."""
    return np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)), p.get("bias")


def clip_text_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``ClipTextEncoder``'s Flax parameter tree with numpy leaves (a
    ``__logit_scale__`` entry, as ``convert_torch_clip_text`` adds, becomes
    the log ``logit_scale``) → a state dict in the OpenAI CLIP namespace for
    ``models.clip_text.load_clip_text_state_dict`` or ``TextTower``."""
    width = np.asarray(params["ln_final"]["scale"]).shape[0]
    sd = {"token_embedding.weight": params["token_embedding"]["embedding"],
          "positional_embedding": params["positional_embedding"],
          "ln_final.weight": params["ln_final"]["scale"],
          "ln_final.bias": params["ln_final"]["bias"],
          "text_projection": params["text_projection"]}
    i = 0
    while f"resblock_{i}" in params:
        b, pre = params[f"resblock_{i}"], f"transformer.resblocks.{i}."
        (sd[pre + "attn.in_proj_weight"], sd[pre + "attn.in_proj_bias"],
         sd[pre + "attn.out_proj.weight"], sd[pre + "attn.out_proj.bias"]) = _attention(
            b["attn"], width)
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = b[ln]["scale"], b[ln]["bias"]
        for flax_name, name in (("mlp_fc", "c_fc"), ("mlp_proj", "c_proj")):
            sd[pre + f"mlp.{name}.weight"], sd[pre + f"mlp.{name}.bias"] = _dense(b[flax_name])
        i += 1
    if "__logit_scale__" in params:
        sd["logit_scale"] = np.log(np.asarray(params["__logit_scale__"], np.float32))
    return {k: _f32(v) for k, v in sd.items()}


def lseg_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``LSegNet``'s Flax parameter tree with numpy leaves → a state
    dict in the demo checkpoint's timm/DPT namespace for
    ``models.lseg.load_lseg_state_dict`` or ``LSegModel``."""
    pos = np.asarray(params["pos_embed"])
    width = pos.shape[-1]
    pm, sd = "pretrained.model.", {}
    sd[pm + "patch_embed.proj.weight"], sd[pm + "patch_embed.proj.bias"] = _conv(
        params["patch_embed"])
    sd[pm + "cls_token"] = np.asarray(params["cls_token"]).reshape(1, 1, width)
    sd[pm + "pos_embed"] = pos[None]
    i = 0
    while f"block_{i}" in params:
        b, pre = params[f"block_{i}"], f"{pm}blocks.{i}."
        (sd[pre + "attn.qkv.weight"], sd[pre + "attn.qkv.bias"], sd[pre + "attn.proj.weight"],
         sd[pre + "attn.proj.bias"]) = _attention(b["attn"], width)
        for ln in ("norm1", "norm2"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = b[ln]["scale"], b[ln]["bias"]
        for fc in ("fc1", "fc2"):
            sd[pre + f"mlp.{fc}.weight"], sd[pre + f"mlp.{fc}.bias"] = _dense(b["mlp"][fc])
        i += 1
    resample = {0: "upsample_0", 1: "upsample_1", 3: "downsample_3"}
    for t in range(4):
        ap = f"pretrained.act_postprocess{t + 1}."
        sd[ap + "0.project.0.weight"], sd[ap + "0.project.0.bias"] = _dense(
            params[f"readout_{t}"])
        sd[ap + "3.weight"], sd[ap + "3.bias"] = _conv(params[f"reassemble_{t}"])
        if t in resample:
            sd[ap + "4.weight"], sd[ap + "4.bias"] = _conv(params[resample[t]])
        sd[f"scratch.layer{t + 1}_rn.weight"] = _conv(params[f"scratch_{t}"])[0]
        fusion, rf = params[f"fusion_{t}"], f"scratch.refinenet{t + 1}."
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if unit in fusion:
                for conv in ("conv1", "conv2"):
                    (sd[f"{rf}{name}.{conv}.weight"],
                     sd[f"{rf}{name}.{conv}.bias"]) = _conv(fusion[unit][conv])
        sd[rf + "out_conv.weight"], sd[rf + "out_conv.bias"] = _conv(fusion["out_conv"])
    sd["scratch.head1.weight"], sd["scratch.head1.bias"] = _conv(params["head"])
    if "__logit_scale__" in params:
        sd["logit_scale"] = np.log(np.asarray(params["__logit_scale__"], np.float32))
    return {k: _f32(v) for k, v in sd.items()}


def lpips_from_params(params: dict):
    """``eval/lpips.load_lpips``'s numpy parameters (HWIO convs, a [C] lin
    vector per layer) → the ``LPIPS`` module (OIHW ``nn.Conv2d`` weights), on
    the CPU."""
    from segsplat_tpu_torch.eval.lpips import LPIPS

    model = LPIPS(params["net"])
    with torch.no_grad():
        for i, conv in enumerate(model.convs()):
            conv.weight.copy_(_f32(np.asarray(params["backbone"][f"conv{i}_w"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(_f32(params["backbone"][f"conv{i}_b"]))
        for k, lin in enumerate(params["lins"]):
            getattr(model, f"lin{k}").copy_(_f32(lin))
    return model
