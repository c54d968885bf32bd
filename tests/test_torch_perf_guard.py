"""The port's perf guard (segsplat_tpu_torch/perf_guard.py): its drift logic
against scripts/perf_guard.py's, the exported programs' counts identical from
run to run at a reduced size (64×48, 500 Gaussians, 2 lift views), and each
blend one op node of the exported frame."""

import functools
import json

import pytest
import torch

from _torch_port import blend_case_args, torch_threads

SMALL = dict(width=64, height=48, n=500, lift_views=2, lift_size=(64, 48, 16, 500))

BASE = {"platform": "cpu",
        "prog": {"flops": 1000.0, "bytes_accessed": 500.0,
                 "temp_bytes": 100, "wall_s_per_unit": 1.0}}
CASES = {  # name: (current, out-of-tolerance rows)
    "inside": ({"prog": {"flops": 1005.0, "bytes_accessed": 500.0, "temp_bytes": 100,
                         "wall_s_per_unit": 1.2}}, 0),
    "flops_and_wall": ({"prog": {"flops": 1100.0, "bytes_accessed": 500.0, "temp_bytes": 100,
                                 "wall_s_per_unit": 1.5}}, 2),
    "bytes_and_temp": ({"prog": {"flops": 1000.0, "bytes_accessed": 506.0, "temp_bytes": 98,
                                 "wall_s_per_unit": 0.76}}, 2),
    "no_wall": ({"prog": {"flops": 1000.0, "bytes_accessed": 500.0, "temp_bytes": 100}}, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_flags_drift_and_respects_tolerance(case, capsys):
    """Counts at ±1 %, the wall at ±25 %, line for line as the JAX guard."""
    from scripts import perf_guard as J
    from segsplat_tpu_torch import perf_guard as P

    current, bad = CASES[case]
    assert P.compare(BASE, current) == bad
    ours = capsys.readouterr().out
    assert J.compare(BASE, current) == bad
    assert ours == capsys.readouterr().out
    assert ours.count("DRIFT") == bad


def test_counts_are_identical_run_to_run(monkeypatch, tmp_path):
    """The CLI twice at a reduced size: ``--out`` writes the counts, a second
    run ``--compare``s clean against them, and every count and node is equal
    (all but the export's seconds)."""
    from segsplat_tpu_torch import perf_guard as P

    monkeypatch.setattr(P, "programs", functools.partial(P.programs, **SMALL))
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    with torch_threads(2):
        P.main(["--device", "cpu", "--no-walltime", "--out", str(a)])
        P.main(["--device", "cpu", "--no-walltime", "--out", str(b), "--compare", str(a)])
    counts = lambda path: {k: ({kk: vv for kk, vv in v.items() if kk != "export_s"}
                               if isinstance(v, dict) else v)
                           for k, v in json.loads(path.read_text()).items()}
    first, second = counts(a), counts(b)
    assert first == second
    names = ("headline_render_1080p_200k", "hostile_render_1080p_200k",
             "lift_officescene_2views")
    assert all(first[n]["flops"] > 0 and first[n]["bytes_accessed"] > first[n]["temp_bytes"] > 0
               for n in names)
    drifted = json.loads(a.read_text())
    drifted[names[2]]["temp_bytes"] *= 1.02
    a.write_text(json.dumps(drifted))
    with torch_threads(2), pytest.raises(SystemExit, match="1"):
        P.main(["--device", "cpu", "--no-walltime", "--compare", str(a)])


def test_each_blend_is_one_op_node_of_the_export():
    """The render program exports with K1 as one ``segsplat_torch::blend_fwd``
    node, and a program that calls K3's ``blend_tiles_packed`` on a packed
    payload with one ``segsplat_torch::blend_packed`` node; nothing of a
    blend's plain version is in either graph, and the render's counts are the
    run's."""
    from segsplat_tpu_torch import bench
    from segsplat_tpu_torch import perf_guard as P
    from segsplat_tpu_torch.ops import blend as B

    fn, arrays, units = P.render_program(bench.headline_render_scene(64, 48, 500))
    args = tuple(torch.as_tensor(a) for a in arrays)
    offsets, payload, bg, tx_n, ty_n, K = blend_case_args("k128_one_block", "cpu", packed=True)
    k3 = lambda offsets, payload, bg: B.blend_tiles_packed(offsets, payload, bg, tx_n, ty_n, K)
    with torch_threads(2):
        nodes = P.graph_counts(torch.export.export(P.Program(fn), args))["nodes"]
        packed = P.graph_counts(torch.export.export(P.Program(k3),
                                                    (offsets, payload, bg)))["nodes"]
    assert units == 1
    assert nodes["segsplat_torch.blend_fwd.default"] == 1
    assert packed["segsplat_torch.blend_packed.default"] == 1
    for graph in (nodes, packed):
        assert not any(op in graph for op in ("aten.cumprod.default", "aten.bmm.default",
                                              "aten.exp.default"))
    assert "segsplat_torch.blend_fwd.default" not in packed
