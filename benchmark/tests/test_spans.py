"""CPU tests of the readers of the program's spans (``harness/spans.py`` and
the nine metrics that use it): a traced run of each tiny cell reads a number
for each of its span metrics (``device_mallocs.train`` none off the card); a
run without a trace, or a program that keeps no records, reads None."""

import contextlib
import io
import json
import time

import pytest

from benchmark.harness.cell import load_cell
from benchmark.harness.runner import run

SPAN_METRICS = {
    "view-officescene-1080p": ["entry_host_ms.view", "project_host_ms.view",
                               "bin_host_ms.view", "gather_host_ms.view",
                               "blend_host_ms.view"],
    "train-officescene-876": ["assign_solve_ms.train", "assign_wait_ms.train",
                              "backward_host_ms.train", "device_mallocs.train"],
}
ON_THE_CARD_ONLY = {"device_mallocs.train"}


def traced_run(root, workload):
    from segsplat_tpu_torch.utils import profiling

    profiling.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run(["--workload", workload, "--seed", "3000000019", "--seconds", "0.5",
                  "--trace", "1"], time.perf_counter(), device="cpu", root=root)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_span_metrics_read_the_traced_run(tiny_root, cell):
    rc, res = traced_run(tiny_root, cell)
    assert rc == 0 and res["correct"] is True, res
    reported = {m["name"] for m in load_cell(cell, tiny_root).per_layer}
    assert set(SPAN_METRICS[cell]) <= reported
    for name in SPAN_METRICS[cell]:
        if name in ON_THE_CARD_ONLY:
            assert name not in res["metrics"]
        else:
            v = res["metrics"][name]
            assert v["unit"] == "ms" and 0 < v["value"] < 1e4, (name, v)


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_span_metrics_read_none_without_a_trace_or_records(tiny_root, cell, monkeypatch):
    from segsplat_tpu_torch.utils import profiling

    rc, _ = traced_run(tiny_root, cell)
    assert rc == 0 and profiling.records()
    c = load_cell(cell, tiny_root)
    untraced = {"trace": None, "window": {"count": 1, "spans": [], "window_s": 1.0}}
    traced = {"trace": {"iterations": 2}, "window": untraced["window"]}
    for name in SPAN_METRICS[cell]:
        assert c.reader(name).read(untraced) is None
    monkeypatch.delattr(profiling, "records")       # a program before the spans
    for name in SPAN_METRICS[cell]:
        assert c.reader(name).read(traced) is None
    profiling.reset()
