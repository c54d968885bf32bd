"""The port's tracing (segsplat_tpu_torch/utils/profiling.py): ``trace``
writing a Chrome trace that holds an ``annotate`` span and the ops inside it;
spans off by default (a shared no-op, no ``record_function``, no record);
the view and train paths' spans under the profiler, with their parents and
their ``user_annotation`` twins in the exported trace; self time and counts
from a fake clock; counts of device values kept as tensors until read;
``enable()`` without a profiler; the bounded buffer; and spans and counts
under ``torch.compile``."""

import json

import numpy as np
import pytest
import torch

from segsplat_tpu_torch.utils import profiling as TP
from _torch_port import port_train_setup

# every span of the view and train paths, with the span around it
VIEW_SPANS = {"render.semantics": None, "raster.project": "render.semantics",
              "raster.bin": "render.semantics", "raster.gather": "render.semantics",
              "raster.blend": "render.semantics"}
TRAIN_SPANS = {"train.step": None, "train.losses": "train.step",
               "render.render": "train.losses", "raster.project": "render.render",
               "raster.bin": "render.render", "raster.gather": "render.render",
               "raster.blend": "render.render", "train.assign": "train.losses",
               "train.assign.fetch": "train.assign", "train.assign.solve": "train.assign",
               "train.backward": "train.step", "train.adam": "train.step",
               "train.stats": "train.step"}


@pytest.fixture(autouse=True)
def _fresh_records():
    TP.disable()
    TP.reset()
    yield
    TP.disable()
    TP.reset()


def _no_range(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function entered for {name}")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_trace_exports_annotated_ranges(tmp_path):
    with TP.trace(str(tmp_path)) as prof:
        with TP.annotate("port.region"):
            torch.ones(8).add_(1).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port.region" in names and "aten::sum" in names
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "port.region" for e in events)
    assert [r.name for r in TP.records()] == ["port.region"]


def test_a_span_off_is_a_shared_no_op(monkeypatch):
    _no_range(monkeypatch)
    monkeypatch.setattr(TP, "_clock", lambda: pytest.fail("an off span read the clock"))

    @TP.annotate("port.decorated")
    def twice(x):
        return 2 * x

    with TP.annotate("port.off", allocs=True):
        assert twice(3) == 6
    assert TP.annotate("port.off") is TP.annotate("port.off")
    assert TP.records() == [] and TP.summary() == {} and TP.dropped() == 0


def _view_frame():
    from segsplat_tpu_torch.core.types import Camera
    from segsplat_tpu_torch.render import render_semantics

    state, _, cams, _, _ = port_train_setup(n_views=1)
    logits = torch.as_tensor(np.random.default_rng(1).normal(
        size=(state.table.capacity, 32)).astype(np.float32))
    c = cams[0]
    cam = Camera(R=c.R, T=c.T, fov_x=c.fov_x, fov_y=c.fov_y, width=64, height=48)
    return lambda: render_semantics(state.table, cam, logits, max_tiles_per_axis=4,
                                    max_per_tile=64, backend="cuda")


def _train_step():
    from segsplat_tpu_torch.train.trainer import make_train_step

    state, cfg, cams, gts, objs = port_train_setup(n_views=1)
    step = make_train_step(cfg, dict(max_tiles_per_axis=4, max_per_tile=64, backend="cuda"))
    idx = torch.arange(0, cams[0].width * cams[0].height, 7)
    return lambda: step(state, cams[0], gts[0], objs[0], torch.zeros(3), idx=idx)


def test_view_and_train_spans_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    frame, step = _view_frame(), _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            frame()
        n_view = len(TP.records())
        step()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    recs = TP.records()
    for got, want in ((recs[:n_view], VIEW_SPANS), (recs[n_view:], TRAIN_SPANS)):
        assert {r.name: r.parent for r in got} == want
        assert all(r.end_ns >= r.start_ns and 0 <= r.self_ns <= r.end_ns - r.start_ns
                   for r in got)
    assert [r.name for r in recs].count("train.adam") == 2      # the reset, the update
    # the rasterizer's counts, read as ints; no CUDA here, so no device_mallocs
    keys = {"raster.bin": {"pairs", "pairs_past_k"}, "raster.gather": {"rows"}}
    assert all(set(r.counts) == keys.get(r.name, set()) for r in recs)
    assert all(type(v) is int and v >= 0 for r in recs for v in r.counts.values())
    ours = set(VIEW_SPANS) | set(TRAIN_SPANS)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in ours), key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in marks] == [r.name for r in sorted(recs, key=lambda r: r.start_ns)]
    # a span's event covers its record: the range opens before the clock is read
    for e, r in zip(marks, sorted(recs, key=lambda r: r.start_ns)):
        assert float(e["dur"]) * 1e3 >= (r.end_ns - r.start_ns) * 0.5


def test_self_time_and_counts_follow_a_fake_clock(monkeypatch):
    ticks = iter([0, 10, 30, 40, 50, 55, 70, 100])
    mallocs = iter([5, 12])
    monkeypatch.setattr(TP, "_clock", lambda: next(ticks))
    monkeypatch.setattr(TP, "_device_mallocs", lambda: next(mallocs))
    TP.enable()
    with TP.annotate("outer", allocs=True):          # 0 .. 100
        with TP.annotate("leaf"):                    # 10 .. 30
            pass
        with TP.annotate("mid"):                     # 40 .. 70
            with TP.annotate("leaf"):                # 50 .. 55
                pass
    by = {(r.name, r.start_ns): r for r in TP.records()}
    assert by[("outer", 0)].self_ns == 100 - 20 - 30 and by[("outer", 0)].parent is None
    assert by[("mid", 40)].self_ns == 25 and by[("mid", 40)].parent == "outer"
    assert by[("leaf", 50)].parent == "mid" and by[("leaf", 10)].parent == "outer"
    assert by[("outer", 0)].counts == {"device_mallocs": 7}
    s = TP.summary()
    assert s["leaf"]["calls"] == 2 and s["leaf"]["total_ms"] == pytest.approx(25e-6)
    assert s["leaf"]["self_ms"] == pytest.approx(25e-6)
    assert s["outer"]["total_ms"] == pytest.approx(100e-6)
    assert s["outer"]["self_ms"] == pytest.approx(50e-6)
    assert s["outer"]["counts"] == {"device_mallocs": 7} and s["mid"]["counts"] == {}


def test_tensor_counts_are_read_only_by_the_readers():
    TP.enable()
    with TP.annotate("outer"):
        with TP.annotate("leaf"):
            TP.count("n", torch.tensor(3))
            TP.count("n", torch.tensor(4, dtype=torch.int32))
            TP.count("k", 2)
        leaf = TP._records[-1]
        # kept as the tensor at the span's exit: a device value is not waited for
        assert isinstance(leaf.counts["n"], torch.Tensor) and leaf.counts["k"] == 2
        TP.count("k", 5)
    assert isinstance(TP._records[0].counts["n"], torch.Tensor)
    recs = TP.records()
    assert [(r.name, r.counts) for r in recs] == [("leaf", {"n": 7, "k": 2}),
                                                   ("outer", {"k": 5})]
    assert all(type(v) is int for r in recs for v in r.counts.values())
    assert type(TP._records[0].counts["n"]) is int            # read once, kept read
    with TP.annotate("leaf"):
        TP.count("n", torch.tensor(1))
    assert TP.summary()["leaf"]["counts"] == {"n": 8, "k": 2}
    assert type(TP.summary()["leaf"]["counts"]["n"]) is int


def test_a_count_without_a_recording_span_leaves_no_record(monkeypatch):
    _no_range(monkeypatch)
    monkeypatch.setattr(TP, "_clock", lambda: pytest.fail("an off count read the clock"))
    TP.count("n", torch.tensor(1))
    with TP.annotate("port.off"):
        TP.count("n", torch.tensor(1))
    assert TP.records() == [] and TP.summary() == {}
    TP.enable()
    TP.count("n", 1)                        # on, but no span open
    assert TP.records() == []


def test_enable_records_without_a_profiler(monkeypatch):
    _no_range(monkeypatch)

    @TP.annotate("port.decorated")
    def inner():
        with TP.annotate("port.inner"):
            return 1

    TP.enable()
    with TP.annotate("port.outer"):
        inner()
    TP.disable()
    inner()
    assert [(r.name, r.parent) for r in TP.records()] == [
        ("port.inner", "port.decorated"), ("port.decorated", "port.outer"),
        ("port.outer", None)]


def test_the_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(TP, "CAPACITY", 3)
    TP.enable()
    for i in range(5):
        with TP.annotate(f"port.{i}"):
            pass
    assert [r.name for r in TP.records()] == ["port.0", "port.1", "port.2"]
    assert TP.dropped() == 2 and TP.summary()["port.2"]["calls"] == 1
    TP.reset()
    assert TP.records() == [] and TP.dropped() == 0


def test_threads_keep_their_own_parents_and_lose_no_count(monkeypatch):
    import sys
    import threading

    monkeypatch.setattr(TP, "CAPACITY", 1000)
    TP.enable()
    n_threads, n_spans = 16, 100

    def work(t):
        for _ in range(n_spans // 2):
            with TP.annotate(f"outer.{t}"):
                with TP.annotate(f"inner.{t}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    recs = TP.records()
    assert len(recs) == 1000 and len(recs) + TP.dropped() == n_threads * n_spans
    assert all(r.parent == "outer." + r.name.split(".")[1] for r in recs
               if r.name.startswith("inner."))
    assert all(r.parent is None for r in recs if r.name.startswith("outer."))


@pytest.mark.parametrize("on", [False, True])
def test_spans_compile_into_one_graph(on):
    @TP.annotate("port.decorated")
    def half(x):
        return x / 2

    def fn(x):
        with TP.annotate("port.compiled", allocs=True):
            return half(x + 1)

    if on:
        TP.enable()
    torch._dynamo.reset()
    out = torch.compile(fn, fullgraph=True, backend="eager")(torch.ones(3))
    assert torch.equal(out, torch.ones(3))
    assert TP.records() == []                   # a compiled span records nothing


@pytest.mark.parametrize("on", [False, True])
def test_a_count_under_compile_does_nothing(on):
    def fn(x):
        with TP.annotate("port.compiled"):
            y = x + 1
            TP.count("port.n", y.sum())
            TP.count("port.rows", y.shape[0])
            return y

    if on:
        TP.enable()
    torch._dynamo.reset()
    out = torch.compile(fn, fullgraph=True, backend="eager")(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert TP.records() == []
