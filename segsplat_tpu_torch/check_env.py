#!/usr/bin/env python
"""Environment check of the port on the card (the counterpart of the repo's
scripts/check_env.py, which probes JAX): prints the torch, CUDA and nvcc
versions and the card's name and power limit, builds the forward blend kernel
K1 from ``csrc/blend_fwd.cu``, launches it once on a seeded scene at 19
channels and holds it against its plain version at 1e-4. Exits non-zero on
any failure, printing ``ALL OK`` last on success.

    python -m segsplat_tpu_torch.check_env
"""

from __future__ import annotations

import subprocess
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

import segsplat_tpu_torch
from segsplat_tpu_torch.ops import blend as B
from segsplat_tpu_torch.ops.rasterize import build_blend_inputs, project_gaussians
from segsplat_tpu_torch.utils import cuda_build

TOL = 1e-4                      # K1 against its plain version, atol and rtol
W, H, CH, K = 64, 48, 19, 256   # a small frame at the viewer's channel count


def k1_inputs(device, n: int = 500, seed: int = 0):
    """The blend inputs of ``n`` seeded Gaussians in front of a W×H camera."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    q = rng.normal(size=(n, 4))
    proj = project_gaussians(
        f32(rng.random((n, 3)) * [3.0, 2.0, 2.0] + [-1.5, -1.0, 1.5]),
        f32(np.exp(rng.normal(-2.5, 0.3, (n, 3)))),
        f32(q / np.linalg.norm(q, axis=1, keepdims=True)),
        f32(np.eye(4)), 60.0, 60.0, W / 2, H / 2, W, H)
    bi = build_blend_inputs(proj, f32(rng.standard_normal((n, CH)) * 2.0),
                            f32(rng.uniform(0.3, 0.95, n)), W, H, 4, K)
    return bi.offsets, bi.sorted_payload, f32(rng.random(CH)), bi.tx_n, bi.ty_n, K


def main(argv=None) -> int:
    ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    print(f"segsplat_tpu_torch {segsplat_tpu_torch.__version__}")
    print(f"torch {torch.__version__} | cuda {torch.version.cuda} | numpy {np.__version__}")
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no card", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")

    t0 = time.perf_counter()
    lib = cuda_build.build_library("blend_fwd")
    print(f"K1 built in {time.perf_counter() - t0:.1f} s: {lib.name}")
    args = k1_inputs("cuda")
    before = B.blend_tiles.launches
    img, alpha = B.blend_tiles(*args)
    torch.cuda.synchronize()
    if B.blend_tiles.launches != before + 1:
        raise RuntimeError("blend_tiles did not launch K1")
    ref_img, ref_alpha = B.blend_tiles_plain(*args)
    err = 0.0
    for got, ref in ((img, ref_img), (alpha, ref_alpha)):
        diff = (got - ref).abs()
        err = max(err, float(diff.max()))
        if not bool(torch.isfinite(got).all()) or bool((diff > TOL + TOL * ref.abs()).any()):
            raise RuntimeError(f"K1 disagrees with its plain version (max abs diff {err:.3g})")
    print(f"K1 launch at {W}x{H}, {CH} channels, K = {K}: max abs diff {err:.3g} "
          f"against its plain version (tolerance {TOL})")
    print("ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
