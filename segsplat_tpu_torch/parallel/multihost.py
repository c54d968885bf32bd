"""Process-group start-up for runs on several devices and hosts (the
counterpart of segsplat_tpu/parallel/multihost.py).

One process drives one device. ``torchrun`` starts the processes and sets
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and the rendezvous address;
``initialize`` then joins them through ``env://``. A launch without torchrun
gives the address itself (``tcp://host:port`` or ``file:///path``) with the
world size and this process's rank. NCCL is the backend on the card; gloo
runs only where the caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from segsplat_tpu_torch.parallel.mesh import make_mesh

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_VARS)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> dict:
    """Join the default process group and return ``topology()``.

    Under torchrun the group forms through ``env://``; otherwise through
    ``coordinator_address`` (``host:port`` means ``tcp://host:port``) with
    ``num_processes`` and ``process_id``. With neither, a single process needs
    no group and none is made. ``backend`` is ``"nccl"`` (the default: each
    rank takes the card cuda:LOCAL_RANK) or ``"gloo"`` (the CPU). A group
    that already exists is kept."""
    if dist.is_initialized():
        return topology()
    if coordinator_address is None and not launched_by_torchrun():
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator_address "
                             "or a torchrun launch")
        return topology()
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA, and torch.cuda.is_available() "
                               "is False; pass backend='gloo' to run on the CPU")
        torch.cuda.set_device(local_rank(process_id))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    return topology()


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's index among the processes of its host: LOCAL_RANK under
    torchrun, else its rank (a launch without torchrun runs on one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_id is not None:
        return process_id
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """The processes on this host: LOCAL_WORLD_SIZE under torchrun, else the
    world (a launch without torchrun runs on one host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return dist.get_world_size() if dist.is_initialized() else 1


def topology() -> dict:
    """The JAX package's keys (one device a process), and the backend."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
        "local_world_size": local_world_size(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }


def make_global_mesh(n_tensor: int = 1):
    """A (view, tensor) mesh over every rank of every host, each tensor group
    inside one host (ranks are host-major, so it suffices that n_tensor
    divides the processes a host runs) and the view axis across hosts."""
    if local_world_size() % n_tensor:
        raise ValueError(f"tensor={n_tensor} does not divide the {local_world_size()} "
                         "processes of a host: a tensor group would span hosts")
    return make_mesh(n_tensor=n_tensor)
