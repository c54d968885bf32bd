"""The port's harness entry (segsplat_tpu_torch/graft_entry.py) against the JAX
package's (__graft_entry__.py): the flagship frame compiles as one graph with
K1 as one op, gives JAX ``entry()``'s outputs on the same draws, and the dry
run's three programs pass on two gloo ranks."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_compiles_as_one_graph():
    """torch.compile(fullgraph=True) of the frame: one graph, no break (the
    blend's early-out and its launch sit inside K1's op), the compiled outputs
    the eager bits (aot_eager: the same ops, no code generation)."""
    from segsplat_tpu_torch import graft_entry as G

    with torch_threads(2):
        fn, args = G.entry(device="cpu")
        explained = torch._dynamo.explain(fn)(*args)
        assert (explained.graph_count, explained.graph_break_count) == (1, 0), \
            explained.break_reasons
        assert "segsplat_torch.blend_fwd" in explained.graphs[0].code
        eager = fn(*args)
        compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")(*args)
    for e, c in zip(eager, compiled):
        assert torch.equal(c, e)


def test_entry_matches_jax_entry():
    """The port's entry on the CPU (K1's plain version) against JAX entry()
    through jax.jit (its "xla" blend) on the same numpy draws, within 1e-4."""
    sys.path.insert(0, ROOT)
    try:
        import jax

        import __graft_entry__ as J
    finally:
        sys.path.remove(ROOT)
    from segsplat_tpu_torch import graft_entry as G

    jfn, jargs = J.entry()
    ref = [np.asarray(o) for o in jax.jit(jfn)(*jargs)]
    with torch_threads(2):
        fn, args = G.entry(device="cpu")
        got = [o.numpy() for o in fn(*args)]
    assert [g.shape for g in got] == [r.shape for r in ref] == [(3, 64, 64), (32, 64, 64), (384,)]
    for name, g, r in zip(("render", "semantic_logits"), got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4, err_msg=name)
        assert np.abs(r).max() > 0.1, name
    np.testing.assert_array_equal(got[2], ref[2])
    assert (ref[2] > 0).sum() > 100


def test_dryrun_on_two_gloo_ranks():
    """dryrun_multichip(2, "cpu") in a child process, with the JAX dry run's
    timeout: the train step held to the world of one, the lift, the strips."""
    r = subprocess.run(
        [sys.executable, "-c",
         "from segsplat_tpu_torch import graft_entry as g; g.dryrun_multichip(2, device='cpu')"],
        cwd=ROOT, capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, f"stdout={r.stdout[-500:]}\nstderr={r.stderr[-2000:]}"
    assert "dryrun_multichip ok: mesh={'view': 1, 'tensor': 2}" in r.stdout
    assert "lift ok" in r.stdout and "voxel_hits=" in r.stdout
    assert "render ok" in r.stdout and "image=32x32" in r.stdout


def test_dryrun_on_cuda_needs_a_card_a_rank(monkeypatch):
    from segsplat_tpu_torch import graft_entry as G

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards, and this machine has 1"):
        G.dryrun_multichip(2, device="cuda")
    assert G.mesh_shape(8) == (4, 2) and G.mesh_shape(3) == (3, 1)
