#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (see README.md).
Without a CUDA card it prints no result and exits 2.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# compile caches at fixed places inside the checkout, before torch is loaded
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(ROOT, "build", "torchinductor")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, ROOT)

from benchmark.harness.runner import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T_START))
