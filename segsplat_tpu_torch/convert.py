"""Carry Gaussian weights and training state from the JAX package into the port.

``table_from_jax_arrays`` takes the numpy form of a JAX ``GaussianTable`` (every
field, e.g. ``{f.name: np.asarray(getattr(t, f.name)) for f in
dataclasses.fields(t)}``) and builds the port's table, so that both packages
compute on the same weights. ``train_state_from_jax_arrays`` takes the numpy
form of a JAX ``TrainState`` (``jax.tree.map(np.asarray, state)``: the same
NamedTuples and dataclasses with numpy leaves) and builds the port's train
state with optax's Adam moments, so that both packages take a step from the
same state. Nothing here imports JAX or optax: the state is read by
attribute names.
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
