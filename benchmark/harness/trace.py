"""A traced sub-window: ``torch.profiler`` (CPU and CUDA activities) over a
few iterations, read back from its Chrome trace and reduced to what the
per-layer readers and the result's ``breakdown`` need. The trace file is
written inside the checkout, read and deleted.

The window is the benchmark's own range ``bench.window``; iterations run in
ranges ``bench.iter`` and anything the harness does between them for its own
counting in ``bench.aside``. Device work (kernels, copies, sets) whose launch
lies in a ``bench.aside`` range is left out of every sum.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW, ITER, ASIDE = "bench.window", "bench.iter", "bench.aside"


@contextlib.contextmanager
def profiled(trace_path: Path) -> Iterator[dict]:
    """Profile the block, the host's operators and, with a card, its device
    work; on exit fill the yielded dict with the reduced trace
    (``summarise``). The block marks its window with ``WINDOW``."""
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    try:
        out.update(summarise(json.loads(trace_path.read_text())["traceEvents"]))
    finally:
        os.unlink(trace_path)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _inside(t: float, spans: List[Tuple[float, float]]) -> bool:
    return any(a <= t <= b for a, b in spans)


def _cut(spans: List[Tuple[float, float]], holes: List[Tuple[float, float]]):
    """``spans`` less the time ``holes`` (merged) cover."""
    out = []
    for a, b in spans:
        for h0, h1 in holes:
            if h1 <= a or h0 >= b:
                continue
            if h0 > a:
                out.append((a, h0))
            a = max(a, h1)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def summarise(events: list) -> dict:
    """From Chrome-trace events (µs): ``window_s`` (the window less its
    ``bench.aside`` ranges), ``busy_s`` (the union of device work in it),
    ``device_s`` by op name, the number of ``iterations``, the idle gaps by
    what the host was doing (``idle_by_host``), and ``device_total_s``."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    asides = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
                     if e.get("name") == ASIDE and e.get("cat") == "user_annotation"])
    iters = sum(1 for e in xs if e.get("name") == ITER and e.get("cat") == "user_annotation"
                and w0 <= float(e["ts"]) <= w1)
    launch_ts = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
    dev, by_name = [], defaultdict(float)
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr in launch_ts and _inside(launch_ts[corr], asides):
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] += (b - a) * 1e-6
    busy = _merge(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    busy, gaps = _cut(busy, asides), _cut(gaps, asides)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") in HOST_CATS and e.get("name") != WINDOW))
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # the latest-starting host event that covers the gap's middle names it
        name = "host idle"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += (b - a) * 1e-6
    return {"window_s": sum(b - a for a, b in _cut([(w0, w1)], asides)) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_s": dict(by_name),
            "device_total_s": sum(by_name.values()),
            "iterations": iters,
            "idle_by_host": dict(idle)}


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a name → seconds map, as [name, seconds]."""
    return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_seconds(tr: dict, match: Optional[str] = None, exclude: Optional[str] = None) -> float:
    """Device seconds of the traced window whose op name contains ``match``
    (all when None) and not ``exclude``."""
    return sum(v for k, v in tr.get("device_s", {}).items()
               if (match is None or match in k) and (exclude is None or exclude not in k))


def idle_pct(tr: Optional[dict], window: dict) -> Optional[float]:
    """The card's idle share of the untimed window, in %: one less the device's
    busy time a traced iteration (the union of its work) over the window's
    mean period (``window_s`` / ``count``, host clock, no profiler running).
    The profiler slows the host, so the traced sub-window's own idle share
    reads high; its device time does not stretch."""
    if not tr or not tr.get("iterations") or not tr.get("busy_s") or not window["count"]:
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / tr["iterations"])
                    / (window["window_s"] / window["count"]))
