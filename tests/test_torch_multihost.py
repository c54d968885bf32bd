"""Process-group start-up of the port (segsplat_tpu_torch/parallel/multihost.py)
on the CPU: ``topology()`` in one process, with the JAX package's keys, and two
processes of this file that join through ``initialize`` at a ``file://``
rendezvous (gloo) and sum one tensor. Unlike tests/test_multihost.py, a
timeout fails the test."""

import json
import os
import sys

import pytest
import torch

from _torch_port import run_ranks, worker_main

HERE = os.path.abspath(__file__)


def test_topology_single_process():
    from segsplat_tpu.parallel import multihost as jax_multihost
    from segsplat_tpu_torch.parallel import multihost

    topo = multihost.topology()
    assert set(jax_multihost.topology()) <= set(topo)
    assert topo["process_index"] == 0 and topo["process_count"] == 1
    assert topo["global_devices"] == topo["local_devices"] == 1
    assert multihost.initialize() == topo                 # one process needs no group
    mesh = multihost.make_global_mesh()
    assert (mesh.n_view, mesh.n_tensor, mesh.groups) == (1, 1, None)
    with pytest.raises(ValueError, match="tensor=2 does not divide the 1 processes"):
        multihost.make_global_mesh(2)
    with pytest.raises(ValueError, match="2 processes need a coordinator_address"):
        multihost.initialize(num_processes=2)
    with pytest.raises(ValueError, match="backend must be"):
        multihost.initialize("file:///nonexistent", 1, 0, backend="mpi")
    if not torch.cuda.is_available():     # NCCL is never swapped for gloo
        with pytest.raises(RuntimeError, match="backend 'nccl' needs CUDA"):
            multihost.initialize("file:///nonexistent", 1, 0)


def reduce_ranks(rank, world, workdir):
    import torch.distributed as dist

    from segsplat_tpu_torch.parallel import multihost

    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x)
    mesh = multihost.make_global_mesh(2)
    with open(os.path.join(workdir, f"reduce_rank{rank}.json"), "w") as f:
        json.dump({"topo": multihost.topology(), "sum": float(x),
                   "mesh": [mesh.n_view, mesh.n_tensor, mesh.view_index, mesh.tensor_index],
                   "again": multihost.initialize() == multihost.topology()}, f)


WORKERS = {"reduce": reduce_ranks}


def test_two_process_initialize_and_reduce(tmp_path):
    run_ranks(HERE, "reduce", 2, tmp_path, timeout=120)
    for rank in range(2):
        r = json.loads((tmp_path / f"reduce_rank{rank}.json").read_text())
        assert r["sum"] == 3.0 and r["again"]
        topo = r["topo"]
        assert (topo["process_index"], topo["process_count"]) == (rank, 2)
        assert topo["global_devices"] == 2 and topo["backend"] == "gloo"
        assert r["mesh"] == [1, 2, 0, rank]


if __name__ == "__main__":
    worker_main(sys.argv[2:], WORKERS)
