"""One run of one cell: set up, measure for ``--seconds``, optionally trace a
short steady sub-window, check the timed path's outputs against the plain
reference, and print the result's line.

A loop (``loops/<name>.py``) provides ``Loop(cell, seed, device)`` with:

  * ``setup()``: build the system under test from the seed and warm up every
    shape the window uses; ``next_index`` is then the window's first
    iteration;
  * ``iterate(i)``: iteration i of the window (a frame, a step), returning
    its host spans as a dict of seconds;
  * ``drain()``: wait for the device at the window's close;
  * ``aside(i)``: what the harness keeps before traced iteration i for its own
    counting (run in the ``bench.aside`` range);
  * ``work(traced)``: the yardstick's counts for the traced iterations;
  * ``release()``: free the program's state;
  * ``check()``: [(name, value, limit)], each value ≤ its limit when correct.

Every metric but ``setup_s`` has a reader ``metrics/<name>.py`` whose
``read(ctx)`` returns a number or None (nothing to read: the metric is left
out of the line).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from benchmark.harness.cell import ROOT, Cell, load_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "segsplat_tpu")
TRACE_FILE = ROOT / "build" / "bench_trace" / "trace.json"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def power_limit() -> Optional[str]:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def measure(loop, seconds: float, start: int = 0) -> dict:
    """Iterations from ``start`` until ``seconds`` have passed, then a drain:
    the window's iterations, their spans and its length."""
    spans = []
    i = start
    t0 = time.perf_counter()
    while True:
        spans.append(loop.iterate(i))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    loop.drain()
    return {"first": start, "count": len(spans), "spans": spans,
            "window_s": time.perf_counter() - t0}


def traced(loop, start: int, count: int) -> dict:
    """``count`` iterations from ``start`` under the profiler; the reduced
    trace with the traced indices."""
    import torch

    from benchmark.harness import trace

    with trace.profiled(TRACE_FILE) as tr:
        with torch.profiler.record_function(trace.WINDOW):
            for i in range(start, start + count):
                with torch.profiler.record_function(trace.ASIDE):
                    loop.aside(i)
                with torch.profiler.record_function(trace.ITER):
                    loop.iterate(i)
            loop.drain()
    tr["indices"] = list(range(start, start + count))
    return tr


def run(argv, t_start: float, device: Optional[str] = None,
        patch: Optional[Callable] = None, root: Path = ROOT) -> int:
    """The run; ``device`` and ``patch`` are for the harness's own tests:
    ``device`` skips the look for a card, ``patch(loop)`` may break the timed
    path underneath before set-up."""
    args = parse(argv)
    cell: Cell = load_cell(args.workload, root)
    import torch

    phases = {"import": time.perf_counter() - t_start}

    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            return fail(f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} present")
        device = "cuda"
        torch.cuda.init()
        phases["device"] = time.perf_counter() - t_start
    dev = torch.device(device)
    loop = cell.loop_module().Loop(cell, args.seed, dev)
    if patch is not None:
        patch(loop)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    phases["setup"] = setup_s
    print(f"benchmark: set-up reached (s from start) {json.dumps(phases)}", file=sys.stderr)
    window = measure(loop, args.seconds, start=loop.next_index)
    tr, work = None, None
    if args.trace:
        n = int(cell.traffic["traced_iterations"])
        tr = traced(loop, window["first"] + window["count"], n)
        work = loop.work(tr["indices"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.release()
    checks = loop.check()
    correct = all(v == v and v <= lim for _, v, lim in checks)

    ctx = {"cell": cell, "window": window, "trace": tr, "work": work, "setup_s": setup_s,
           "config": cell.config, "traffic": cell.traffic}
    metrics = {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        value = setup_s if m["name"] == "setup_s" else cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package are loaded: {found}", 3)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        info["power_limit"] = power_limit()
    if tr is not None:
        info["busy_s"] = tr.get("busy_s", 0.0)
        info["window_s"] = tr.get("window_s", 0.0)
    result = {"correct": bool(correct), "attempted": window["count"], "failed": 0,
              "metrics": metrics, "device": info}
    if tr is not None:
        from benchmark.harness.trace import top

        result["breakdown"] = {"device_ops": top(tr.get("device_s", {})),
                               "idle_gaps": top(tr.get("idle_by_host", {}))}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    return run(sys.argv[1:] if argv is None else argv, t_start)
