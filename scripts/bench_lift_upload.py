#!/usr/bin/env python3
"""Time the lift's map upload on one NVIDIA GPU, at the lift cell's sizes
(``benchmark/configs/officescene-room-lift.json``: fp16 maps [512, 360, 540],
199 MB, lifted along 876×584 rays into 91 520 voxels).

    python3 scripts/bench_lift_upload.py [--seed N] [--views 32] [--rounds 3]
                                         [--out build/lift_upload.json]

Measures, medians over repeats:

  * ``pin_alloc_ms``: the first pinned buffer of a map's size, allocated;
  * ``host_copy``: the host's copy of a pageable map into pinned memory, by
    ``torch``'s ``copy_`` (its intra-op threads), by ``numpy.copyto`` and by
    ``pin_memory`` (the caching host allocator's block, as ``MapStage``);
  * ``h2d``: the map's copy to the card from pageable memory (``.to``) and
    from pinned memory (``non_blocking``, CUDA events);
  * ``stage``: over ``--rounds`` rounds, ``MapStage.upload`` alone and whole
    views of a ``ViewLifter`` back to back (as the benchmark's lift loop runs
    them);
  * ``spans``: the host's self time of each of the lifter's spans, ms a
    view, over ``--views`` views (``utils/profiling``, no profiler);
  * ``syncs``: the Python lines of one view that make a synchronising call
    (``torch.cuda.set_sync_debug_mode("warn")``), in order;
  * ``trace``: a profiled window of 4 views: the host-to-device copies (kind,
    bytes, ms, GB/s) and the share of their time that overlaps the kernels
    launched inside ``lift.tile_test``, and the device time a view.

Writes the JSON to ``--out`` and prints it, with the card's name and power
limit. Needs a card: without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness.cell import load_cell  # noqa: E402
from segsplat_tpu_torch.pipeline import lift_features as LF  # noqa: E402


def _median_s(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def _event_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _lifter(cell, scene):
    cfg = cell.config
    lcfg = LF.LiftConfig(depth_min=cfg["depth_min"], depth_max=cfg["depth_max"],
                         ray_increment_factor=cfg["ray_increment_factor"],
                         downsample_factor=cfg["downsample"],
                         splat_max_tiles_per_axis=cfg["max_tiles_per_axis"],
                         splat_max_per_tile=cfg["max_per_tile"],
                         splat_big_budget=cfg["big_budget"])
    return LF.ViewLifter(scene["centers"], cfg["cell_size"], scene["origin"],
                         tuple(int(v) for v in scene["cells"].max(axis=0) + 1),
                         cfg["channels"], cfg["height"], cfg["width"], lcfg, "cuda")


def _views_per_s(lifter, scene, views: int) -> float:
    maps, c2w, intr = scene["maps"], scene["c2w"], scene["intrinsics"]
    for i in range(3):
        lifter.lift(maps[i % len(maps)], c2w[i], intr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(views):
        lifter.lift(maps[i % len(maps)], c2w[i % len(c2w)], intr)
    torch.cuda.synchronize()
    return views / (time.perf_counter() - t0)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _trace(lifter, scene, views: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    maps, c2w, intr = scene["maps"], scene["c2w"], scene["intrinsics"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(views):
            lifter.lift(maps[i % len(maps)], c2w[i], intr)
        torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        ev = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    tile_ranges = [(e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("cat") == "user_annotation" and e.get("name") == "lift.tile_test"]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    in_tile = [(e["ts"], e["ts"] + e["dur"]) for e in kernels
               if any(a <= launch.get(e["args"].get("correlation"), -1) <= b
                      for a, b in tile_ranges)]
    copies = [e for e in ev if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    big = [e for e in copies if e["args"].get("bytes", 0) >= 1 << 20]
    by_kind = {}
    for e in big:
        k = by_kind.setdefault(e["name"], {"count": 0, "bytes": 0, "ms": 0.0})
        k["count"] += 1
        k["bytes"] += e["args"].get("bytes", 0)
        k["ms"] += e["dur"] * 1e-3
    for k in by_kind.values():
        k["gb_per_s"] = k["bytes"] / (k["ms"] * 1e-3) / 1e9 if k["ms"] else None
        k["mb_per_view"] = k["bytes"] / views / 1e6
    cp = _merge([[e["ts"], e["ts"] + e["dur"]] for e in big])
    tt = _merge([list(t) for t in in_tile])
    cp_us = sum(b - a for a, b in cp)
    device = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return {"views": views, "h2d_big_copies": by_kind,
            "h2d_copy_ms_per_view": cp_us * 1e-3 / views,
            "tile_test_kernel_ms_per_view": sum(b - a for a, b in tt) * 1e-3 / views,
            "h2d_overlapping_tile_test_pct": 100.0 * _overlap(cp, tt) / cp_us if cp_us else None,
            "device_ms_per_view": sum(e["dur"] for e in device) * 1e-3 / views,
            "device_busy_ms_per_view": sum(b - a for a, b in _merge(
                [[e["ts"], e["ts"] + e["dur"]] for e in device])) * 1e-3 / views}


def _spans(lifter, scene, views: int) -> dict:
    from segsplat_tpu_torch.utils import profiling

    maps, c2w, intr = scene["maps"], scene["c2w"], scene["intrinsics"]
    torch.cuda.synchronize()
    profiling.reset()
    profiling.enable()
    t0 = time.perf_counter()
    try:
        for i in range(views):
            lifter.lift(maps[i % len(maps)], c2w[i % len(c2w)], intr)
        torch.cuda.synchronize()
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    out = {"period_ms": (time.perf_counter() - t0) * 1e3 / views}
    for r in recs:
        out[r.name] = out.get(r.name, 0.0) + r.self_ns * 1e-6 / views
    return out


def _syncs(lifter, scene) -> list:
    maps, c2w, intr = scene["maps"], scene["c2w"], scene["intrinsics"]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            lifter.lift(maps[1], c2w[1], intr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in got
            if "synchroniz" in str(w.message)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 25)
    ap.add_argument("--views", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/lift_upload.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    cell = load_cell("lift-officescene")
    scene = cell.scene_module().draw(cell.config, args.seed, torch.device("cuda"))
    fmap = scene["maps"][0]
    nbytes = fmap.nbytes
    out = {"card": smi.strip(), "torch": torch.__version__, "threads": torch.get_num_threads(),
           "map_bytes": nbytes}

    t0 = time.perf_counter()
    pinned = torch.empty(fmap.shape, dtype=torch.float16, pin_memory=True)
    out["pin_alloc_ms"] = (time.perf_counter() - t0) * 1e3
    src = torch.from_numpy(fmap)
    dev = torch.empty(fmap.shape, dtype=torch.float16, device="cuda")
    t_torch = _median_s(lambda: pinned.copy_(src), 7)
    t_np = _median_s(lambda: np.copyto(pinned.numpy(), fmap), 7)
    t_cached = _median_s(lambda: src.pin_memory(), 7)
    t_page = _median_s(lambda: src.to("cuda"), 7)
    t_pin = _event_ms(lambda: dev.copy_(pinned, non_blocking=True), 7) * 1e-3
    out["host_copy"] = {"torch_copy_ms": t_torch * 1e3, "torch_copy_gb_per_s": nbytes / t_torch / 1e9,
                        "numpy_copyto_ms": t_np * 1e3, "numpy_copyto_gb_per_s": nbytes / t_np / 1e9,
                        "pin_memory_ms": t_cached * 1e3, "pin_memory_gb_per_s": nbytes / t_cached / 1e9}
    out["h2d"] = {"pageable_ms": t_page * 1e3, "pageable_gb_per_s": nbytes / t_page / 1e9,
                  "pinned_ms": t_pin * 1e3, "pinned_gb_per_s": nbytes / t_pin / 1e9}
    del pinned, dev
    print(json.dumps(out), flush=True)

    lifter = _lifter(cell, scene)
    stage = LF.MapStage(torch.device("cuda"))
    stage.upload(fmap)
    stage.read()
    runs = {"upload_ms": [], "views_per_s": []}
    for r in range(args.rounds):
        runs["upload_ms"].append(_median_s(lambda: (stage.upload(fmap), stage.read()), 5) * 1e3)
        runs["views_per_s"].append(_views_per_s(lifter, scene, args.views))
        print(r, {k: v[-1] for k, v in runs.items()}, flush=True)
    out["stage"] = {k: statistics.median(v) for k, v in runs.items()}
    out["spans"] = _spans(lifter, scene, args.views)
    out["syncs"] = _syncs(lifter, scene)
    out["trace"] = _trace(lifter, scene, 4)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
