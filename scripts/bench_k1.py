#!/usr/bin/env python3
"""Time the forward tile blends K1 (segsplat_tpu_torch/csrc/blend_fwd.cu) and K3
(csrc/blend_packed.cu) and variants of their sources alone, in turns, on one
NVIDIA GPU, on the inputs chip_smoke.py gives them.

    python3 scripts/bench_k1.py [--variant NAME=PATH] [--k3-variant NAME=PATH]
                                [--rounds 3] [--only k1|k3|indexed] [--seed N]

A variant is a CUDA source with the kernel's C entry point
(``segsplat_blend_fwd`` or ``segsplat_blend_packed``), or ``repo`` for the
repo's own. scripts/k1_variants.py writes K1's alternative designs; an older commit's
sources come from ``git archive``. Each is built with the port's nvcc flags into
build/k1_bench/, keyed like the port's libraries by the source, the headers
beside it and the flags (all builds in parallel); ptxas's registers and spills
are printed. The repo's sources always run as ``repo``, and again as ``clocks``,
built with -DSEGSPLAT_CLOCKS: that build reports each segment's share of the
warps' cycles (csrc/blend_common.cuh) and is timed only as a diagnostic. It
also counts the warp-rows the kernel's own lists keep, and the script fails
unless that count is at least the warp-rows with a passing lane and within
KEPT_SLACK of the warp-rows read of the plain counter's ``kept``.

Inputs, as chip_smoke.py phases 5, 3 and 7 build them: K1 on the 19-channel
render of the train step's table (876×584, capacity 262 144, 200 000 Gaussians,
m = 3, K = 256), the 1920×1080 headline and hostile frames at 32 channels, and
the 51-channel render of the same table; K3 on the packed payloads of the two
frames and of the 51-channel render. Every variant is held against the plain
version at 1e-4. Times are medians of CUDA-event timings of one call, over
rounds that visit the variants in turn, forward then backward. Per input it
also prints the warp-rows read, kept by the row lists and hit (a pixel passes
the cut), by the plain counter, and the kept and hit warp-rows of every row up
to each tile's count for the 8×4 block and the 16×2 strip footprints, then
one JSON object per input and the card's name and power limit.

``indexed`` (run by default, alone with ``--only indexed``): K1's indexed
variant (``blend_tiles_indexed``, every no-grad render's blend) against K1 on
the gathered payload (``blend_tiles``), both through their wrappers, in turns,
on the headline and hostile frames and on the benchmark's two view scenes
(benchmark/configs officescene-semantic32 and officescene-clustered, drawn
from ``--seed``, at 1920×1080 from the viewer's camera at the origin). Per
input: both kernels' ms, the same bits asserted, each path's payload build
from the projection on (``build_blend_inputs``: binning, the N·m²-row gather
and its K pad; ``chip_smoke.indexed_inputs``: binning and the N-row table),
the plain version's rows and pair-pixels, K1's bound on them, each kernel's
share of it and both instantiations' occupancy.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import importlib
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import chip_smoke as S  # noqa: E402  (the scenes, cameras and comparisons)

CSRC = ROOT / "segsplat_tpu_torch" / "csrc"
SEGMENTS = ("prologue", "staging_wait", "barrier_early_out", "row_test", "sweep", "colour",
            "epilogue")
KERNELS = {"k1": "blend_fwd", "k3": "blend_packed"}
FOOTPRINTS = {"block_8x4": (8, 4), "strip_16x2": (16, 2)}
# The kernel's row test divides for its 1-D minimum with __fdividef and takes
# the device's logf, where the plain one divides exactly and takes torch.log,
# so on a row at the threshold the two may part: at most this share of the
# warp-rows read.
KEPT_SLACK = 1e-5


def parse_variant(spec: str, kernel: str):
    """NAME=PATH → (name, source path, no extra nvcc flags)."""
    name, path = spec.split("=", 1)
    return name, CSRC / f"{kernel}.cu" if path == "repo" else Path(path), ()


def build(kernel: str, name: str, src: Path, flags):
    """The variant's C entry point, built into build/k1_bench/."""
    from segsplat_tpu_torch.utils import cuda_build

    all_flags = cuda_build.NVCC_FLAGS + tuple(flags)
    out = ROOT / "build" / "k1_bench" / f"{kernel}-{name}-{cuda_build.source_key(src, all_flags)}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([cuda_build.nvcc(), *all_flags, "-o", str(out), str(src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} {flags}:\n{r.stdout}")
        regs = [ln.strip() for ln in r.stdout.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {kernel} {name}: {'; '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, f"segsplat_{kernel}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn.clocks = getattr(lib, f"segsplat_{kernel}_clocks", None)
    fn.occupancy = getattr(lib, f"segsplat_{kernel}_occupancy", None)
    return fn


def call(fn, args, g):
    import torch

    offsets, payload, bg, tx_n, ty_n, K = args
    ch = bg.shape[0]
    img = torch.empty((ty_n * 16, tx_n * 16, ch), device=payload.device)
    alpha = torch.empty((ty_n * 16, tx_n * 16), device=payload.device)
    err = fn(offsets.data_ptr(), payload.data_ptr(), bg.data_ptr(), img.data_ptr(),
             alpha.data_ptr(), tx_n, ty_n, K, g, ch, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return img, alpha


def clock_shares(fn, args, g):
    """Each segment's share of the warps' cycles in one call, and the
    warp-rows the kernel's lists kept in it."""
    import torch

    counters = (ctypes.c_ulonglong * (len(SEGMENTS) + 1))()
    fn.clocks(counters, 1)
    call(fn, args, g)
    torch.cuda.synchronize()
    if fn.clocks(counters, 1) != 0:
        raise RuntimeError("reading the clock counters failed")
    cycles = counters[:len(SEGMENTS)]
    total = sum(cycles) or 1
    return {s: c / total for s, c in zip(SEGMENTS, cycles)}, counters[len(SEGMENTS)]


def check_kept(label: str, kernel_kept: int, work: dict) -> None:
    """The kernel's own lists keep every warp-row with a passing lane, and as
    many as the plain counter's, to within KEPT_SLACK of those read."""
    if not (work["hit"] <= kernel_kept
            and abs(kernel_kept - work["kept"]) <= KEPT_SLACK * work["read"]):
        raise AssertionError(f"{label}: the kernel's lists kept {kernel_kept} warp-rows, the "
                             f"plain counter {work['kept']} (hit {work['hit']}, "
                             f"read {work['read']})")


def occupancy(fn, ch: int):
    """(blocks of 256 threads per SM, shared bytes per block, registers per
    thread, local bytes per thread) from the variant's occupancy entry, if any."""
    if fn.occupancy is None:
        return None
    vals = [ctypes.c_int() for _ in range(4)]
    if fn.occupancy(ch, *(ctypes.byref(v) for v in vals)) != 0:
        raise RuntimeError("occupancy query failed")
    return dict(zip(("blocks_per_sm", "smem_bytes", "registers", "local_bytes"),
                    (v.value for v in vals)))


def render_args(ch: int):
    """K1's arguments from the render of the train step's table at 19
    channels, or at 51 with chip_smoke's seeded logits."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import render as R
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.train import trainer as T

    pts, cols, _, _ = S.train_scene()
    table = T.init_table_from_pcd(pts, cols, S.TRAIN_CAP, max_sh_degree=3, seed=0,
                                  device=S.DEV)
    kw = {}
    if ch == 51:
        kw["semantic_logits"] = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (S.TRAIN_CAP, 32), dtype=np.float32), device=S.DEV)
    from segsplat_tpu_torch.ops import rasterize as Pr

    cap, k1, k1_indexed = {}, B.blend_tiles, Pr.blend_tiles_indexed

    def record(*args):
        cap["args"] = args
        return k1(*args)

    def record_indexed(offsets, ids, table, bg, tx_n, ty_n, K):
        # the no-grad render reads table[ids]: the gathered payload, bit for bit
        cap["args"] = (offsets, torch.nn.functional.pad(table[ids], (0, 0, 0, K)), bg,
                       tx_n, ty_n, K)
        return k1_indexed(offsets, ids, table, bg, tx_n, ty_n, K)

    record.launches = 0     # blend_tiles counts under its module name, now this one

    with torch.no_grad(), S.swapped(B, blend_tiles=record), \
            S.swapped(Pr, blend_tiles_indexed=record_indexed):
        R.render(table, S.train_camera(0.0), torch.zeros(3, device=S.DEV),
                 max_tiles_per_axis=3, max_per_tile=256, **kw)
    return cap["args"]


def frame_args(name: str):
    import torch

    sc = S.bench_scene(name)
    _, bi = S.blend_inputs_on_card(sc, S.FRAME_W, S.FRAME_H, S.bench_camera(), sc["m"],
                                   sc["K"], pair_cap=sc["pair_cap"])
    return (bi.offsets, bi.sorted_payload, torch.zeros(32, device=S.DEV), bi.tx_n, bi.ty_n,
            sc["K"])


def packed_of(args):
    from segsplat_tpu_torch.ops import blend as B

    offsets, payload, bg, tx_n, ty_n, K = args
    return offsets, B.pack_payload(payload[:-K], K), bg, tx_n, ty_n, K


def footprint_rows(args, packed: bool):
    """Kept and hit warp-rows of every row up to each tile's count (no
    early-out) for each footprint; K3's rows are couples."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    offsets, payload, bg, tx_n, ty_n, K = args
    pairs = payload.view(-1, B.PACKED_HALF) if packed else payload
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], K)
    g = torch.arange(K, device=pairs.device)
    out = {f: {"kept": 0, "hit": 0} for f in FOOTPRINTS}
    chunk = max(1, (1 << 23) // (K * B.PX))
    for t0 in range(0, tx_n * ty_n, chunk):
        tiles = torch.arange(t0, min(t0 + chunk, tx_n * ty_n), device=pairs.device)
        live = g[None, :] < counts[tiles][:, None]
        win = pairs[off[tiles][:, None] + g[None, :]]
        px, py = B._pixel_centres(tiles, tx_n)
        valid = B._block_alpha(win, px, py, live)[-1]
        for name, fp in FOOTPRINTS.items():
            kept = B.warp_row_may_hit(win, tiles, tx_n, fp) & live[..., None]
            hit = B._per_warp(valid, fp)
            if packed:
                kept, hit = kept[:, 0::2] | kept[:, 1::2], hit[:, 0::2] | hit[:, 1::2]
            out[name]["kept"] += int(kept.sum())
            out[name]["hit"] += int(hit.sum())
    return out


def bench(kernel: str, fns: dict, label: str, args, rounds: int):
    import torch

    from segsplat_tpu_torch.ops import blend as B

    packed = kernel == "blend_packed"
    g = 128 if packed else B.g_block(args[-1])
    plain = B.blend_tiles_packed_plain if packed else B.blend_tiles_plain
    ref = plain(*args)
    errs = {n: S.compare(f"{label} {n}", call(fn, args, g), ref) for n, fn in fns.items()}
    del ref
    times = {n: [] for n in fns}
    order = list(fns)
    for r in range(rounds):
        for n in (order if r % 2 == 0 else order[::-1]):
            times[n].append(S.cuda_time_ms(lambda: call(fns[n], args, g), reps=20))
    counter = B.blend_tiles_packed_warp_rows if packed else B.blend_tiles_warp_rows
    work = counter(*args)
    clocks = {n: clock_shares(fn, args, g) for n, fn in fns.items() if fn.clocks}
    ch = args[2].shape[0]
    print(json.dumps({
        "kernel": kernel, "input": label, "ch": ch, "pairs": int(args[0][-1]),
        "ms": {n: statistics.median(t) for n, t in times.items()}, "max_abs_err": errs,
        "cycle_shares": {n: shares for n, (shares, _) in clocks.items()},
        "kernel_kept": {n: kept for n, (_, kept) in clocks.items()},
        "occupancy": {n: occupancy(fn, ch) for n, fn in fns.items() if fn.occupancy},
        "warp_rows": work, "footprints": footprint_rows(args, packed)}), flush=True)
    for n, (_, kept) in clocks.items():
        check_kept(f"{kernel} {label} {n}", kept, work)
    torch.cuda.empty_cache()


def frame_pair(proj, colors, opac, W: int, H: int, m: int, K: int, pair_cap=None):
    """One frame's K1 arguments on the gathered payload and the indexed
    variant's, and each path's payload build from the projection on."""
    import torch

    from segsplat_tpu_torch.ops import rasterize as Pr

    bg = torch.zeros(colors.shape[1], device=S.DEV)
    bi = Pr.build_blend_inputs(proj, colors, opac, W, H, m, K, pair_cap=pair_cap)
    builds = {"gathered_payload": lambda: Pr.build_blend_inputs(proj, colors, opac, W, H, m, K,
                                                                pair_cap=pair_cap),
              "indexed_table": lambda: S.indexed_inputs(proj, colors, opac, W, H, m, K, bg,
                                                        pair_cap=pair_cap)}
    return ((bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K), builds["indexed_table"](),
            builds)


def headline_pair(name: str):
    """chip_smoke's 1080p frame of bench.py's ``name`` scene, as ``frame_pair``."""
    import torch

    from segsplat_tpu_torch.ops import rasterize as Pr

    sc = S.bench_scene(name)
    t = {k: torch.as_tensor(sc[k], device=S.DEV) for k in ("xyz", "scales", "quats", "opac",
                                                           "logits")}
    vm, fx, fy, cx, cy = S.bench_camera()
    with torch.no_grad():
        proj = Pr.project_gaussians(t["xyz"], t["scales"], t["quats"],
                                    torch.as_tensor(vm, device=S.DEV), fx, fy, cx, cy,
                                    S.FRAME_W, S.FRAME_H)
        return frame_pair(proj, t["logits"], t["opac"], S.FRAME_W, S.FRAME_H, sc["m"],
                          sc["K"], sc["pair_cap"])


def view_pair(config: str, seed: int):
    """The benchmark configuration's scene (``benchmark/scenes``) at 1920×1080
    from the viewer's camera (fov 1.2 × 0.75 rad) at the origin, as
    ``frame_pair``."""
    import torch

    from segsplat_tpu_torch.ops import rasterize as Pr

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    s = importlib.import_module(f"benchmark.scenes.{cfg['scene']}").draw(cfg, seed, S.DEV)
    W, H = 1920, 1080
    with torch.no_grad():
        proj = Pr.project_gaussians(s["xyz"], torch.exp(s["log_scales"]), s["quats"],
                                    torch.eye(4, device=S.DEV), W / (2 * math.tan(0.6)),
                                    H / (2 * math.tan(0.375)), W / 2, H / 2, W, H)
        return frame_pair(proj, s["logits"], torch.sigmoid(s["opacity_logit"])[:, 0], W, H,
                          cfg["max_tiles_per_axis"], cfg["max_per_tile"])


def bench_indexed(label: str, pair, rounds: int):
    """K1's indexed variant against K1 on the gathered payload on one frame."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    args, iargs, builds = pair
    kernels = {"gathered": lambda: B.blend_tiles(*args),
               "indexed": lambda: B.blend_tiles_indexed(*iargs)}
    got, ref = kernels["indexed"](), kernels["gathered"]()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{label}: K1's indexed variant parts from K1 on the gathered "
                             f"payload")
    p_img, p_alpha, rows, hits, _ = B.blend_tiles_plain_with_work(*args)
    err = S.compare(f"{label} indexed", got, (p_img, p_alpha))
    del got, ref, p_img, p_alpha
    times = {n: [] for n in kernels}
    for r in range(rounds):
        for n in (list(kernels) if r % 2 == 0 else list(kernels)[::-1]):
            times[n].append(S.cuda_time_ms(kernels[n], reps=20))
    ms = {n: statistics.median(t) for n, t in times.items()}
    offsets, bg, tx_n, ty_n = args[0], args[2], args[3], args[4]
    ch = bg.shape[0]
    bound_ms, bound_by, _, _ = S.k1_bound(offsets, rows, hits, ch, tx_n * ty_n)
    with torch.no_grad():
        build_ms = {n: S.cuda_time_ms(fn, reps=10) for n, fn in builds.items()}
    print(json.dumps({
        "kernel": "blend_fwd_indexed", "input": label, "ch": ch, "pairs": int(offsets[-1]),
        "slots": int(iargs[1].shape[0]), "table_rows": int(iargs[2].shape[0]), "ms": ms,
        "build_ms": build_ms, "max_abs_err": err, "rows_read": rows, "pixels_hit": hits,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "roofline_pct": {n: 100 * bound_ms / t for n, t in ms.items()},
        "occupancy": {"gathered": B.blend_forward_occupancy("blend_fwd", ch),
                      "indexed": B.blend_forward_occupancy("blend_fwd", ch, "_indexed")}}),
          flush=True)
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--k3-variant", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", choices=("k1", "k3", "indexed"))
    ap.add_argument("--seed", type=int, default=3300000007,
                    help="the benchmark view scenes' draw (indexed)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k1: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    specs = {}
    for key, extra in (("k1", a.variant), ("k3", a.k3_variant)):
        if a.only in (None, key):
            kernel = KERNELS[key]
            specs[kernel] = [("repo", CSRC / f"{kernel}.cu", ()),
                             ("clocks", CSRC / f"{kernel}.cu", ("-DSEGSPLAT_CLOCKS=1",))]
            specs[kernel] += [parse_variant(v, kernel) for v in extra]
    jobs = [(k, *v) for k, vs in specs.items() for v in vs]
    with ThreadPoolExecutor(max(len(jobs), 1)) as ex:
        built = list(ex.map(lambda j: build(*j), jobs))
    fns = {k: {} for k in specs}
    for (kernel, name, _, _), fn in zip(jobs, built):
        fns[kernel][name] = fn

    if "blend_fwd" in fns:
        for label, make in (("train CH=19", lambda: render_args(19)),
                            ("headline CH=32", lambda: frame_args("headline")),
                            ("hostile CH=32", lambda: frame_args("hostile")),
                            ("logits CH=51", lambda: render_args(51))):
            bench("blend_fwd", fns["blend_fwd"], label, make(), a.rounds)
    if "blend_packed" in fns:
        for label, make in (("headline CH=32", lambda: packed_of(frame_args("headline"))),
                            ("hostile CH=32", lambda: packed_of(frame_args("hostile"))),
                            ("logits CH=51", lambda: packed_of(render_args(51)))):
            bench("blend_packed", fns["blend_packed"], label, make(), a.rounds)
    if a.only in (None, "indexed"):
        for label, make in (("headline CH=32", lambda: headline_pair("headline")),
                            ("hostile CH=32", lambda: headline_pair("hostile")),
                            ("officescene-semantic32", lambda: view_pair(
                                "officescene-semantic32", a.seed)),
                            ("officescene-clustered", lambda: view_pair(
                                "officescene-clustered", a.seed))):
            bench_indexed(label, make(), a.rounds)
    print(S.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
