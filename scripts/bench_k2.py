#!/usr/bin/env python3
"""Time kernel K2 (segsplat_tpu_torch/csrc/blend_bwd.cu) and variants of its
source on the three inputs chip_smoke.py times it on, in turns, on one NVIDIA GPU.
A variant from scripts/k2_variants.py's ``clocks`` also reports each segment's
share of the warps' cycles.

    python3 scripts/bench_k2.py [--variant NAME=path/to/blend_bwd.cu ...]
                                [--diagnostic NAME=path ...] [--rounds 3]

Each variant is a CUDA source with K2's C entry point ``segsplat_blend_bwd``;
it is built with the port's nvcc flags into build/k2_bench/ (all builds in
parallel), and the repo's source always runs as variant ``repo``. Inputs, as
chip_smoke.py phases 5, 3 and 7a build them: the 19-channel render of the
train step's table (876×584, capacity 262 144, 200 000 Gaussians, m = 3,
K = 256), the 1920×1080 headline frame at 32 channels (m = 3, K = 256), and
the 51-channel render of the same table; the renders' cotangents come from a
seeded linear functional of their outputs. Every variant is held against K2's
plain version (rtol 5e-3, atol 2e-4·max|ref|), except a ``--diagnostic`` one: a
source with part of the kernel taken out, timed to see what that part costs. Times are medians of
CUDA-event timings of one call (the d_payload zero-fill included, as
chip_smoke.py times ``blend_tiles_bwd``), over rounds that visit the variants
in turn, forward then backward. Prints one JSON object per input, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import chip_smoke as S  # noqa: E402  (the scenes, cameras and comparisons)


def build(name: str, src: Path):
    """The variant's ``segsplat_blend_bwd``, built into build/k2_bench/."""
    from segsplat_tpu_torch.utils import cuda_build

    text = src.read_bytes()
    out = ROOT / "build" / "k2_bench" / f"{name}-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                            str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}")
        regs = [ln.strip() for ln in r.stdout.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.segsplat_blend_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn.clocks = getattr(lib, "segsplat_k2_clocks", None)   # scripts/k2_variants.py
    return fn


def clock_shares(fn, args) -> dict:
    """Each segment's share of the warps' cycles in one call of a ``clocks``
    variant (scripts/k2_variants.py)."""
    import torch

    from k2_variants import SEGMENTS

    counters = (ctypes.c_ulonglong * len(SEGMENTS))()
    fn.clocks(counters, 1)
    call(fn, args)
    torch.cuda.synchronize()
    if fn.clocks(counters, 1) != 0:
        raise RuntimeError("reading the clock counters failed")
    total = sum(counters) or 1
    return {s: counters[i] / total for i, s in enumerate(SEGMENTS)}


def render_inputs(ch: int):
    """K2's inputs and cotangents from the render of the train step's table
    at 19 channels, or 51 with seeded logits."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import render as R
    from segsplat_tpu_torch.train import trainer as T
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    pts, cols, _, _ = S.train_scene()
    table = T.init_table_from_pcd(pts, cols, S.TRAIN_CAP, max_sh_degree=3, seed=0,
                                  device=S.DEV)
    for f in PARAM_FIELDS:
        getattr(table, f).requires_grad_(True)
    rng = np.random.default_rng(5)
    kw, outputs = {}, S.LOGIT_OUTPUTS[:2]
    if ch == 51:
        kw["semantic_logits"] = torch.as_tensor(
            rng.standard_normal((S.TRAIN_CAP, 32), dtype=np.float32), device=S.DEV)
        outputs = S.LOGIT_OUTPUTS
    out = R.render(table, S.train_camera(0.0), torch.zeros(3, device=S.DEV),
                   max_tiles_per_axis=3, max_per_tile=256, **kw)
    total = sum((torch.as_tensor(rng.standard_normal((c, S.TRAIN_H, S.TRAIN_W),
                                                     dtype=np.float32), device=S.DEV)
                 * out[k]).sum() for k, c in outputs)
    cap = {}
    S.capture_blend(total, cap)
    total.backward()
    offsets, payload, bg, img, alpha = (t.detach() for t in cap["saved"])
    g_img, g_alpha = (torch.zeros_like(x) if g is None else g.detach().contiguous()
                      for g, x in zip(cap["grads"], (img, alpha)))
    return (offsets, payload, bg, img, alpha, g_img, g_alpha) + tuple(cap["dims"])


def headline_inputs():
    """K2's inputs on the 1080p headline frame at 32 channels, with a seeded
    cotangent of the image (chip_smoke.py's k2_on_frame)."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    sc = S.bench_scene("headline")
    _, bi = S.blend_inputs_on_card(sc, S.FRAME_W, S.FRAME_H, S.bench_camera(), sc["m"],
                                   sc["K"], pair_cap=sc["pair_cap"])
    bg = torch.zeros(32, device=S.DEV)
    img, alpha = B.blend_tiles(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, sc["K"])
    gen = torch.Generator(S.DEV).manual_seed(3)
    g_img = torch.randn(img.shape, generator=gen, device=S.DEV)
    return (bi.offsets, bi.sorted_payload, bg, img, alpha, g_img, torch.zeros_like(alpha),
            bi.tx_n, bi.ty_n, sc["K"])


def warp_rows(args):
    """(warp-rows read, warp-rows with a pair-pixel past the cut): a warp-row is
    one payload row against one warp's 32 pixels (16 × 2), as K2's phase A
    sweeps them; every row up to a tile's count is read."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = args
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], K)
    g = torch.arange(K, device=payload.device)
    read = hit = 0
    chunk = max(1, (1 << 24) // (K * B.PX))
    for t0 in range(0, tx_n * ty_n, chunk):
        tiles = torch.arange(t0, min(t0 + chunk, tx_n * ty_n), device=payload.device)
        live = g[None, :] < counts[tiles][:, None]                  # [C, K]
        win = payload[off[tiles][:, None] + g[None, :]]
        px, py = B._pixel_centres(tiles, tx_n)
        valid = B._block_alpha(win, px, py, live)[-1]               # [C, K, 256]
        read += int(live.sum()) * 8
        hit += int(valid.reshape(*valid.shape[:2], 8, 32).any(-1).sum())
    return read, hit


def call(fn, args):
    import torch

    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = args
    d_payload = torch.zeros_like(payload)
    err = fn(offsets.data_ptr(), payload.data_ptr(), bg.data_ptr(), img.data_ptr(),
             alpha.data_ptr(), g_img.data_ptr(), g_alpha.data_ptr(), d_payload.data_ptr(),
             tx_n, ty_n, K, bg.shape[0], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return d_payload


def main() -> int:
    import torch

    from segsplat_tpu_torch.ops import blend as B

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--diagnostic", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k2: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    variants = {"repo": ROOT / "segsplat_tpu_torch" / "csrc" / "blend_bwd.cu"}
    variants.update((v.split("=", 1)[0], Path(v.split("=", 1)[1]))
                    for v in a.variant + a.diagnostic)
    unchecked = {v.split("=", 1)[0] for v in a.diagnostic}
    with ThreadPoolExecutor(len(variants)) as ex:
        fns = dict(zip(variants, ex.map(lambda kv: build(*kv), variants.items())))

    for label, make in (("train CH=19", lambda: render_inputs(19)),
                        ("headline CH=32", headline_inputs),
                        ("logits CH=51", lambda: render_inputs(51))):
        args = make()
        ref, _ = B.blend_tiles_bwd_plain(*args)
        errs = {n: S.compare_grad(f"{label} {n}", call(fn, args), ref)
                for n, fn in fns.items() if n not in unchecked}
        del ref
        times = {n: [] for n in fns}
        order = list(fns)
        for r in range(a.rounds):
            for n in (order if r % 2 == 0 else order[::-1]):
                times[n].append(S.cuda_time_ms(lambda: call(fns[n], args), reps=10))
        shares = {n: clock_shares(fn, args) for n, fn in fns.items() if fn.clocks}
        wr_read, wr_hit = warp_rows(args)
        print(json.dumps({"input": label, "pairs": int(args[0][-1]), "ms": {
            n: statistics.median(t) for n, t in times.items()}, "max_abs_err": errs,
            "cycle_shares": shares, "warp_rows": wr_read, "warp_rows_hit": wr_hit}),
            flush=True)
        del args
        torch.cuda.empty_cache()
    print(S.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
