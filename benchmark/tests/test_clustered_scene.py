"""The clustered scene (``scenes/clustered_render.py``) and its configuration:
the layout (cluster centres and counts) is the configuration's for every
``--seed``, the rest of the draw repeats by seed, the counts sum to the
Gaussians, and the cell loads and runs through the harness, reading its
gather's dead share from the program's counts."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness.cell import load_cell
from benchmark.tests.conftest import tiny_copy
from benchmark.tests.test_benchmark_harness import run_cell

CELL = "view-clustered-1080p"
SMALL = {"gaussians": 3000}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The tiny copy of the benchmark, the clustered configuration cut to
    ``SMALL`` too (its widths as the cell's)."""
    torch.set_num_threads(2)
    root = tiny_copy(tmp_path_factory.mktemp("clustered"))
    p = root / "benchmark" / "configs" / "officescene-clustered.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), **SMALL)))
    return root


def test_the_configuration_loads_through_the_harness():
    c = load_cell(CELL)
    assert c.traffic["loop"] == "view" and c.chips == 1
    cfg = c.config
    assert (cfg["scene"], cfg["gaussians"], cfg["channels"], cfg["clusters"],
            cfg["layout_seed"], cfg["max_tiles_per_axis"], cfg["max_per_tile"],
            cfg["pair_cap"], cfg["reduced"]) == ("clustered_render", 200_000, 32, 40, 7, 6,
                                                 512, None, [])
    assert "gather_dead_pct.view" in {m["name"] for m in c.per_layer}


def test_the_layout_is_the_configurations_and_the_rest_repeats_by_seed(small_root):
    c = load_cell(CELL, small_root)
    scene = c.scene_module()
    centres, counts = scene.layout(c.config)
    assert counts.sum() == c.config["gaussians"] and (counts >= 1).all()
    assert centres.shape == (c.config["clusters"], 3)
    again = scene.layout(dict(c.config, gaussians=c.config["gaussians"]))
    assert np.array_equal(again[0], centres) and np.array_equal(again[1], counts)
    assign = torch.repeat_interleave(torch.arange(len(counts)), torch.as_tensor(counts))
    home = torch.as_tensor(centres, dtype=torch.float32)[assign]
    a, b, other = (scene.draw(c.config, s, "cpu") for s in (2 ** 31 + 7, 2 ** 31 + 7, 8))
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], other[k]), k
        assert a[k].dtype == torch.float32 and a[k].shape[0] == c.config["gaussians"]
    for d in (a, other):                     # each Gaussian about its cluster's centre
        assert float((d["xyz"] - home).abs().max()) < 0.08 * 6


def test_the_cell_runs_and_reads_the_gathers_dead_share(small_root):
    rc, res = run_cell(small_root, CELL, seed=3_000_000_029, trace=1)
    assert rc == 0 and res["correct"] is True, res
    v = res["metrics"]["gather_dead_pct.view"]
    assert v["unit"] == "%" and 0 < v["value"] < 100


def test_span_counts_equal_the_references_binning(small_root):
    from benchmark.harness.cell import BENCH_DIR, load_module

    tool = load_module(BENCH_DIR / "tools" / "span_counts.py")
    r = tool.span_counts(load_cell(CELL, small_root), 3_000_000_031, 0.5, torch.device("cpu"))
    assert r["equal"] and len(r["frames"]) == load_cell(CELL, small_root).traffic[
        "traced_iterations"]
    assert all(f["pairs_past_k"] > 0 and f["rows"] == 3000 * 36 for f in r["frames"])
