#!/usr/bin/env python3
"""The rasterizer's span counts on a view cell's traced frames against the
plain reference's binning, on the card, in one process:

    python3 benchmark/tools/span_counts.py --workload <view cell> --seed <n> [--seconds 2]

Sets up and measures a short window as a run of the benchmark does, traces
the mix's ``traced_iterations`` frames, then holds each frame's ``pairs`` and
``pairs_past_k`` (``raster.bin``) against the reference's real pairs and the
pairs past K of its tile runs (``reference/raster.bin_tiles`` offsets, as
``Loop.work`` counts them), and prints ``rows`` (``raster.gather``) beside
them: one JSON line, ``equal`` true when every frame's counts are the
reference's. Exits 1 where they differ or the program keeps no counts. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(ROOT, "build", "torchinductor")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness.cell import load_cell  # noqa: E402
from benchmark.harness.runner import measure, power_limit, traced  # noqa: E402


def span_counts(cell, seed: int, seconds: float, device) -> dict:
    from segsplat_tpu_torch.utils import profiling

    loop = cell.loop_module().Loop(cell, seed, device)
    loop.setup()
    window = measure(loop, seconds, start=loop.next_index)
    profiling.reset()
    tr = traced(loop, window["first"] + window["count"], int(cell.traffic["traced_iterations"]))
    recs = profiling.records()
    bins = [r.counts for r in recs if r.name == "raster.bin"]
    gathers = [r.counts for r in recs if r.name == "raster.gather"]
    work = loop.work(tr["indices"])
    loop.release()
    frames = []
    for i, w, b, g in zip(tr["indices"], work, bins, gathers):
        frames.append({"frame": i, "pairs": b.get("pairs"), "ref_pairs": w["pairs"],
                       "pairs_past_k": b.get("pairs_past_k"),
                       "ref_pairs_past_k": w["pairs"] - w["rows_bwd"], "rows": g.get("rows")})
    equal = len(frames) == len(work) and all(
        f["pairs"] == f["ref_pairs"] and f["pairs_past_k"] == f["ref_pairs_past_k"]
        for f in frames)
    return {"seed": seed, "frames": frames, "equal": equal}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_counts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    r = span_counts(load_cell(args.workload), args.seed, args.seconds, dev)
    r.update(device=kind, power_limit=power_limit() if dev.type == "cuda" else None)
    print(json.dumps(r), flush=True)
    return 0 if r["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
