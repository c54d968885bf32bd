"""The correctness check fails where it must: each cell's control (the plain
reference in the program's place, its blend in bfloat16) and each fault the
cell can have, planted under the timed path of a whole run at a size the CPU
holds, make ``correct`` false. ``tools/readings.py`` reads the same variants
on the card at the cells' own sizes."""

import pytest

from benchmark.harness.cell import load_cell
from benchmark.tests.test_benchmark_harness import CELLS, run_cell


def variants():
    out = []
    for cell in CELLS:
        mod = load_cell(cell).loop_module()
        out += [(cell, v) for v in ("control",) + tuple(mod.FAULTS)]
    return out


@pytest.mark.parametrize("cell,variant", variants())
def test_control_and_faults_are_not_correct(tiny_root, cell, variant):
    mod = load_cell(cell, tiny_root).loop_module()
    undo = []
    try:
        rc, res = run_cell(tiny_root, cell, seed=2_900_000_123,
                           patch=lambda loop: undo.append(mod.plant(loop, variant)))
    finally:
        for u in undo:
            u()
    assert rc == 0 and res["correct"] is False, res["checks"]


def window_faults():
    out = []
    for cell in CELLS:
        mod = load_cell(cell).loop_module()
        if hasattr(mod.Loop, "probe_readout"):
            out += [(cell, v) for v in mod.FAULTS]
    return out


@pytest.mark.parametrize("cell,fault", window_faults())
def test_a_fault_that_starts_in_the_window_is_caught(tiny_root, cell, fault):
    """A step broken only once set-up is over, as a path swapped in after the
    warm-up would be, passes the set-up's steps and fails the probe's."""
    mod = load_cell(cell, tiny_root).loop_module()
    undo = []

    def patch(loop):
        setup = loop.setup

        def then_break():
            setup()
            undo.append(mod.plant(loop, fault))
        loop.setup = then_break

    try:
        rc, res = run_cell(tiny_root, cell, seed=2_900_000_321, patch=patch)
    finally:
        for u in undo:
            u()
    checks = res["checks"]
    assert rc == 0 and res["correct"] is False, checks
    assert all(c["value"] <= c["limit"] for n, c in checks.items() if not n.startswith("window_"))
