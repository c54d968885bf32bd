"""The port's timing and tracing helpers (segsplat_tpu_torch/utils/
profiling.py): StepTimer's EMA and ``timed`` as in the JAX package, ``trace``
writing a Chrome trace that holds an ``annotate`` range and the ops inside
it."""

import json
import time

import pytest
import torch

from segsplat_tpu.utils import profiling as JP
from segsplat_tpu_torch.utils import profiling as TP


def test_step_timer_and_timed_match_jax(monkeypatch):
    clock = iter([0.0, 0.010, 1.0, 2.0] * 2)       # steps of 10 ms, then 1 s, each timer
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    port, ref = TP.StepTimer(ema=0.6), JP.StepTimer(ema=0.6)
    for timer in (port, port, ref, ref):
        with timer:
            pass
    assert port.ms == pytest.approx(ref.ms) and port.ms == pytest.approx(0.6 * 10 + 0.4 * 1e3)
    assert TP.StepTimer().ms == 0.0

    results = {}
    monkeypatch.setattr(time, "perf_counter", iter([5.0, 5.25]).__next__)
    with TP.timed("block", results):
        pass
    assert results == {"block": [0.25]}


def test_trace_exports_annotated_ranges(tmp_path):
    with TP.trace(str(tmp_path)) as prof:
        with TP.annotate("port.region"):
            torch.ones(8).add_(1).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port.region" in names and "aten::sum" in names
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "port.region" for e in events)
