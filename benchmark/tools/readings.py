#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the card, in one process:
the numbers ``check()`` compares for the program and for planted variants
(``control``: the reference in the program's place at the precision below;
the loop's ``FAULTS``), each on several seeds at the cell's own size.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --variants program,control --seconds 2 [--keep-every N] [--probe-within N]

Each run sets up, measures a short window (``--seconds``) and checks, as a run
of the benchmark does; ``--keep-every`` keeps more frames of a short window
for the check (a planted reference frame takes about a second), and
``--probe-within`` draws a train window's probe step among fewer of its
first steps, so that a short window reaches it. Prints one
JSON line a variant and seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(ROOT, "build", "torchinductor")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness.cell import load_cell  # noqa: E402
from benchmark.harness.runner import measure, power_limit  # noqa: E402


def reading(cell, seed: int, variant: str, seconds: float, device) -> dict:
    mod = cell.loop_module()
    loop = mod.Loop(cell, seed, device)
    undo = None if variant == "program" else mod.plant(loop, variant)
    t0 = time.perf_counter()
    try:
        loop.setup()
        setup_s = time.perf_counter() - t0
        window = measure(loop, seconds, start=loop.next_index)
        loop.release()
        t1 = time.perf_counter()
        checks = loop.check()
    finally:
        if undo is not None:
            undo()
    return {"variant": variant, "seed": seed, "setup_s": setup_s, "iterations": window["count"],
            "check_s": time.perf_counter() - t1,
            "checks": {n: v for n, v, _ in checks}}


def pair_range(cell, seed: int, n: int, device) -> dict:
    """The pair count's range over the first ``n`` iterations of the path, on
    the geometry set-up leaves (the reference's binning)."""
    loop = cell.loop_module().Loop(cell, seed, device)
    loop.setup()
    for i in range(n):
        loop.aside(i)
    work = loop.work(range(n))
    pairs = [w["pairs"] for w in work]
    past = [w["pairs"] - w["rows_bwd"] for w in work]
    loop.release()
    return {"seed": seed, "iterations": n, "pairs_min": min(pairs), "pairs_max": max(pairs),
            "past_K_min": min(past), "past_K_max": max(past), "pairs_first": pairs[0],
            "past_K_first": past[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--keep-every", type=int, default=None)
    ap.add_argument("--probe-within", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=0,
                    help="also count the pairs of the path's first N iterations (one seed)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.keep_every:
        cell.traffic["keep_every"] = args.keep_every
    if args.probe_within:
        cell.traffic["probe_within"] = args.probe_within
    dev = torch.device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": kind, "power_limit": power_limit()}), flush=True)
    if args.pairs:
        print(json.dumps(pair_range(cell, int(args.seeds.split(",")[0]), args.pairs, dev)),
              flush=True)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = reading(cell, seed, variant, args.seconds, dev)
            print(json.dumps(r), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
