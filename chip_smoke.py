#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (segsplat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: print the card and its power limit; build the three CUDA kernels from
     segsplat_tpu_torch/csrc with nvcc, one process per source, in parallel.
  2. kernels vs plain on small scenes, the cases of tests/_torch_port.py, at
     19, 32 and 51 channels: K = 128, 256 and 384 (one 128-row block, one
     256-row block, three 128-row blocks with the transmittance carry), an
     opaque scene that takes the forward's block early-out, and a pair_cap
     truncation. K1 (forward) at 1e-4; K2 (backward) at rtol 5e-3, atol
     2e-4·max|ref|, with the rows no tile owns exactly 0, also on empty tiles
     and a tile past its K cap; a wide, faint K = 256 scene whose tile counts
     leave K2 a partial last chunk; K3 (packed forward) on the same cases and
     an opaque K = 256 one at 1e-4, and against K1; K1 and K3 at 1e-4 on the
     degenerate tiles and on edge tiles (count 0, one row, count > K, partial
     last chunks, rows at the edges of the row test). On every input the row
     lists of K1 and K3 (the plain counter) keep no fewer warp-rows than hit.
  3. K1 vs plain at full scale: 1920×1080, 200 000 Gaussians, 32 channels, the
     headline scene (seed 0, m=3, K=256, pair_cap 1.5M) and the hostile one
     (seed 7, m=6, K=512, pair_cap 6M), built as bench.py builds them; times the
     kernel, its plain version and the whole rasterize with CUDA events, and
     reckons the kernel's bound from the rows and pair-pixels this data needs.
     On the headline frame also the gradient of a seeded linear functional of
     rasterize's image, which launches K2 at 32 channels, and K2 on that
     frame's cotangent against its plain version, timed.
  4. the semantic render path through its entry point: the CLI twin
     segsplat_tpu_torch/render_semantics_logits.py renders 4 views at 1080p of a
     model dir written here; K1's launch count must rise, and view 0's logits
     must match the plain blend on the same inputs.
  5. the full-width train step of scripts/perf_train.py's configuration
     (876×584, capacity 262 144, 200 000 Gaussians from its seed, m=3, K=256,
     256 classes): step 1's loss terms and gradients with K1 + K2 against the
     same step with both plain versions on the card; K1 (19 channels) and K2 vs
     their plain versions on that step's own blend inputs and cotangents, timed,
     with their bounds; then 10 steps timed with CUDA events, split into forward
     render, losses, the host LAP, backward and optimizers.
  6. the training path through its entry point: the CLI twin
     ``python -m segsplat_tpu_torch.train`` for 20 iterations on a Blender-style
     scene written here (3 views at 876×584, a 200 000-point cloud, capacity
     262 144), with a densify step and an opacity reset, then eval and save; K1
     and K2 must launch at least once per iteration, the losses must be finite
     and the saved PLY must reload through the port's load_gaussian_table.
  7. the one-pass 51-channel render and the rasterizer's other blend paths:
     (a) ``render(..., semantic_logits=...)`` of phase 5's table (876×584, m=3,
     K=256, seeded [262 144, 32] logits): forward with K1 at 51 channels and the
     gradient of a seeded linear functional of render, render_object and
     semantic_logits with K2 at 51 channels, against the same calls with the
     plain blends; K1 and K2 timed at 51 channels with their bounds;
     (b) the packed kernel K3, turned on through ``rasterize``'s USE_PACKED in
     this process only, on the headline and hostile 1080p scenes (32 channels)
     and on (a)'s 51-channel render: its launch count must rise; against its
     plain version at 1e-4 and against K1 at 1e-4 + 2·SAT_EPS·max(|colour|,
     |bg|), timed with its bound and with the whole packed rasterize;
     (c) the dense backend (the JAX package's "xla") on the headline scene,
     forward, against K1 at 1e-4, timed.
Prints a ``{"kernels": [...]}`` line (each kernel's blocks per SM, shared
memory and registers from the occupancy API; K1's and K3's share of warp-rows
their row lists keep beside the share with a passing lane), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when CUDA
is unavailable or the package is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ATOL = RTOL = 1e-4          # K1 against its plain version
GRAD_RTOL, GRAD_ATOL_REL = 5e-3, 2e-4   # gradients: rtol, atol as a share of max|ref|
KERNELS = ("blend_fwd", "blend_bwd", "blend_packed")
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3
FRAME_W, FRAME_H = 1920, 1080   # the headline and hostile frames (bench.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` calls of the device time of ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_grad(name: str, got, ref) -> float:
    """Max abs diff; raises beyond rtol 5e-3, atol 2e-4·max|ref| (the tolerance
    of tests/test_blend_vjp.py) or on a non-finite value."""
    import torch

    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    worst = float(diff.max()) if diff.numel() else 0.0
    atol = GRAD_ATOL_REL * float(ref.abs().max()) if ref.numel() else 0.0
    if not torch.isfinite(got).all() or float((diff - (atol + GRAD_RTOL * ref.abs())).max()) > 0:
        raise AssertionError(f"{name}: differs from its reference (max abs diff {worst:.3g}, "
                             f"atol {atol:.3g})")
    return worst


def compare(name: str, got, ref, atol: float = ATOL) -> float:
    """Max abs diff of (img, alpha) pairs; raises beyond atol + rtol·|ref|."""
    import torch

    worst = 0.0
    for g, r in zip(got, ref):
        diff = (g - r).abs()
        worst = max(worst, float(diff.max()))
        excess = float((diff - (atol + RTOL * r.abs())).max())
        if not torch.isfinite(g).all() or excess > 0:
            raise AssertionError(f"{name}: kernel disagrees with plain version "
                                 f"(max abs diff {worst:.3g})")
    return worst


# ───────────────────────────── scenes (numpy, seeded) ─────────────────────────

def headline_scene(N: int = 200_000):
    """bench.py:80-102, seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    xyz = (rng.random((N, 3)) * np.array([4.0, 3.0, 4.0])
           + np.array([-2.0, -1.5, 2.0])).astype(np.float32)
    scales = np.exp(rng.normal(-4.6, 0.3, (N, 3))).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, (N,)).astype(np.float32)
    logits = rng.standard_normal((N, 32)).astype(np.float32)
    return dict(xyz=xyz, scales=scales, quats=quats, opac=opac, colors=logits,
                m=3, K=256, pair_cap=1_500_000)


def hostile_scene(N: int = 200_000):
    """bench.py:105-132, seed 7: 40 tight clusters, mixed scales, low opacity."""
    import numpy as np

    rng = np.random.default_rng(7)
    n_clusters = 40
    cl_centers = (rng.random((n_clusters, 3)) * np.array([4.0, 3.0, 4.0])
                  + np.array([-2.0, -1.5, 2.0]))
    w = rng.pareto(1.2, n_clusters) + 0.05
    counts = np.maximum((w / w.sum() * N).astype(int), 1)
    counts[0] += N - counts.sum()
    assign = np.repeat(np.arange(n_clusters), counts)[:N]
    xyz = (cl_centers[assign] + rng.normal(0, 0.08, (N, 3))).astype(np.float32)
    scales = np.exp(rng.normal(-4.3, 0.8, (N, 3))).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.02, 0.9, (N,)).astype(np.float32)
    logits = rng.standard_normal((N, 32)).astype(np.float32)
    return dict(xyz=xyz, scales=scales, quats=quats, opac=opac, colors=logits,
                m=6, K=512, pair_cap=6_000_000)


def bench_camera(W: int = 1920, H: int = 1080):
    """bench.py's camera: identity pose, fov_x 1.2, fov_y 0.75 → (viewmat, fx, fy, cx, cy)."""
    import numpy as np

    fx = W / (2.0 * math.tan(0.6))
    fy = H / (2.0 * math.tan(0.375))
    return np.eye(4, dtype=np.float32), fx, fy, W / 2.0, H / 2.0


# ───────────────────────────────── phases ─────────────────────────────────────

def blend_inputs_on_card(sc, W, H, cam, m, K, pair_cap=None, packed=False):
    import torch

    from segsplat_tpu_torch.ops.rasterize import build_blend_inputs, project_gaussians

    dev = torch.device("cuda")
    t = {k: torch.as_tensor(sc[k], device=dev) for k in ("xyz", "scales", "quats",
                                                         "opac", "colors")}
    vm, fx, fy, cx, cy = cam
    proj = project_gaussians(t["xyz"], t["scales"], t["quats"],
                             torch.as_tensor(vm, device=dev), fx, fy, cx, cy, W, H)
    return t, build_blend_inputs(proj, t["colors"], t["opac"], W, H, m, K,
                                 pair_cap=pair_cap, packed=packed)


def phase_small(results):
    import numpy as np
    import torch

    from segsplat_tpu_torch.ops import blend as B

    # the case table and scenes of tests/test_torch_blend_cuda.py
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _torch_port import (BLEND_CASES, DEGENERATE_K, PACKED_CASES, PACKED_G,
                             assert_case_exercised, blend_case_args, degenerate_case_args,
                             edge_case_args, owned_rows)

    gen = torch.Generator("cuda").manual_seed(0)
    for ch in B.KERNEL_CHANNELS:
        for name in sorted(BLEND_CASES):
            args = blend_case_args(name, "cuda", ch=ch)
            offsets, payload, K = args[0], args[1], args[-1]
            got = B.blend_tiles(*args)
            ref_img, ref_alpha, rows, hits, _ = B.blend_tiles_plain_with_work(*args)
            torch.cuda.synchronize()
            err = compare(f"{name} CH={ch}", got, (ref_img, ref_alpha))
            counts = np.minimum(np.diff(offsets.cpu().numpy()), K)
            assert_case_exercised(name, offsets.cpu().numpy(), K, rows)
            lists = warp_row_shares(f"{name} CH={ch} K1", B.blend_tiles_warp_rows(*args))
            results["fwd_err"] = max(results["fwd_err"], err)

            g_img = torch.randn(ref_img.shape, generator=gen, device="cuda")
            g_alpha = torch.randn(ref_alpha.shape, generator=gen, device="cuda")
            bargs = (offsets, payload, args[2], ref_img, ref_alpha, g_img, g_alpha) + args[3:]
            d_pay, d_bg = B.blend_tiles_bwd(*bargs)
            ref_pay, ref_bg, brows, bhits = B.blend_tiles_bwd_plain_with_work(*bargs)
            torch.cuda.synchronize()
            berr = max(compare_grad(f"{name} CH={ch} d_payload", d_pay, ref_pay),
                       compare_grad(f"{name} CH={ch} d_bg", d_bg, ref_bg))
            owned = torch.as_tensor(owned_rows(offsets.cpu().numpy(), K, payload.shape[0]),
                                    device="cuda")
            if bool((d_pay[~owned] != 0).any()):
                raise AssertionError(f"{name} CH={ch}: K2 wrote a row no tile owns")
            results["bwd_err"] = max(results["bwd_err"], berr)
            log(f"[small] {name} CH={ch}: K={K} pairs={int(offsets[-1])} "
                f"deepest={int(counts.max())} fwd rows_read={rows}/{int(counts.sum())} "
                f"pixels_hit={hits} max_abs_err={err:.3g} warp-rows kept "
                f"{lists['kept_share']:.3f} hit {lists['hit_share']:.3f}; bwd rows_read={brows} "
                f"pixels_hit={bhits} max_abs_err={berr:.3g}")

        # K2 on empty tiles and on a tile past its K cap: those rows stay 0
        offsets, payload, bg, tx_n, ty_n, K = degenerate_case_args("cuda", ch=ch)
        img, alpha = B.blend_tiles_plain(offsets, payload, bg, tx_n, ty_n, K)
        bargs = (offsets, payload, bg, img, alpha, torch.randn(img.shape, generator=gen,
                                                               device="cuda"),
                 torch.randn(alpha.shape, generator=gen, device="cuda"), tx_n, ty_n, K)
        d_pay, d_bg = B.blend_tiles_bwd(*bargs)
        ref_pay, ref_bg = B.blend_tiles_bwd_plain(*bargs)
        torch.cuda.synchronize()
        berr = max(compare_grad(f"degenerate CH={ch} d_payload", d_pay, ref_pay),
                   compare_grad(f"degenerate CH={ch} d_bg", d_bg, ref_bg))
        owned = torch.as_tensor(owned_rows(offsets.cpu().numpy(), DEGENERATE_K,
                                           payload.shape[0]), device="cuda")
        if bool((d_pay[~owned] != 0).any()):
            raise AssertionError(f"degenerate CH={ch}: K2 wrote a row no tile owns")
        results["bwd_err"] = max(results["bwd_err"], berr)
        log(f"[small] degenerate tiles CH={ch} (counts 0 and past K={K}): K2 "
            f"max_abs_err={berr:.3g}, unowned rows 0")

        # K1 and K3 on the degenerate tiles and on the edge tiles
        for case, args in (("degenerate", degenerate_case_args("cuda", ch=ch)),
                           ("edge", edge_case_args("cuda", ch=ch))):
            offsets, payload, bg, tx_n, ty_n, K = args
            pargs = (offsets, B.pack_payload(payload[:-K], K), bg, tx_n, ty_n, K)
            err = compare(f"{case} tiles CH={ch} K1", B.blend_tiles(*args),
                          B.blend_tiles_plain(*args))
            perr = compare(f"{case} tiles CH={ch} K3", B.blend_tiles_packed(*pargs),
                           B.blend_tiles_packed_plain(*pargs))
            lists = warp_row_shares(f"{case} tiles CH={ch} K1", B.blend_tiles_warp_rows(*args))
            plists = warp_row_shares(f"{case} tiles CH={ch} K3",
                                     B.blend_tiles_packed_warp_rows(*pargs))
            results["fwd_err"] = max(results["fwd_err"], err)
            results["packed_err"] = max(results["packed_err"], perr)
            log(f"[small] {case} tiles CH={ch} (counts {np.diff(offsets.cpu().numpy()).tolist()}, "
                f"K={K}): K1 max_abs_err={err:.3g}, K3 {perr:.3g}; warp-rows kept/hit "
                f"K1 {lists['warp_rows_kept']}/{lists['warp_rows_hit']}, K3 "
                f"{plists['warp_rows_kept']}/{plists['warp_rows_hit']}")

        for name in sorted(PACKED_CASES):
            args = blend_case_args(name, "cuda", ch=ch, packed=True)
            got = B.blend_tiles_packed(*args)
            ref_img, ref_alpha, rows, hits, stopped = B.blend_tiles_packed_plain_with_work(*args)
            torch.cuda.synchronize()
            err = compare(f"{name} CH={ch} K3", got, (ref_img, ref_alpha))
            assert_case_exercised(name, args[0].cpu().numpy(), args[-1], rows, g=PACKED_G)
            warp_row_shares(f"{name} CH={ch} K3", B.blend_tiles_packed_warp_rows(*args))
            dense = blend_case_args(name, "cuda", ch=ch)
            k1_err = compare(f"{name} CH={ch} K3 vs K1", got, B.blend_tiles(*dense),
                             atol=packed_atol(dense[1], dense[2]))
            results["packed_err"] = max(results["packed_err"], err)
            log(f"[small] {name} CH={ch} K3: rows_read={rows} pixels_hit={hits} "
                f"tiles_stopped={stopped} max_abs_err={err:.3g}; vs K1 {k1_err:.3g}")


def warp_row_shares(name: str, work: dict) -> dict:
    """The row lists of K1 or K3 on one input, as the plain counter gives them
    (``blend_tiles_warp_rows``): warp-rows read, kept and hit, and the kept
    and hit shares of those read. Raises if the lists keep fewer warp-rows
    than have a passing lane, or none is read."""
    read, kept, hit = work["read"], work["kept"], work["hit"]
    if not (hit <= kept <= read and read > 0):
        raise AssertionError(f"{name}: warp-rows read {read}, kept {kept}, hit {hit}")
    return dict(warp_rows_read=read, warp_rows_kept=kept, warp_rows_hit=hit,
                kept_share=kept / read, hit_share=hit / read)


def packed_atol(payload, bg) -> float:
    """K3 against K1: 1e-4 + 2·SAT_EPS·max(|colour|, |bg|). K3's 128-pair
    early-out may stop a saturated tile one block before K1's 256-row one; what
    it leaves out is below SAT_EPS of transmittance times a colour."""
    from segsplat_tpu_torch.ops.blend import GEOM, SAT_EPS

    ch = bg.shape[0]
    top = max(float(payload[:, GEOM:GEOM + ch].abs().max()), float(bg.abs().max()))
    return ATOL + 2 * SAT_EPS * top


def _bound(ops: float, bytes_: float):
    """(bound ms, what bounds it): the larger of fp32 operations over 67 TFLOP/s
    and bytes over 3.35 TB/s."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k1_bound(offsets, rows: int, hits: int, ch: int, num_tiles: int,
             row_bytes: int = 0):
    """K1's bound on this data: every pair-pixel of a row read costs dx, dy,
    sigma, exp, alpha and the cut (15 ops); one that passes the cut CH fmas, the
    weight and T's update (2·CH + 3). Bytes: the rows read (``row_bytes`` each,
    0: K1's payload_width(CH) floats; K3's in ``k3_row_bytes``), offsets, bg,
    image and alpha written."""
    from segsplat_tpu_torch.ops.blend import payload_width

    ops = rows * 256 * 15 + hits * (2 * ch + 3)
    bytes_ = (rows * (row_bytes or payload_width(ch) * 4) + offsets.numel() * 4 + ch * 4
              + num_tiles * 256 * (ch + 1) * 4)
    return _bound(ops, bytes_) + (ops, bytes_)


def k3_row_bytes(ch: int) -> int:
    """Bytes K3 reads per pair: of the 256-byte packed pair it stages only the
    2 + ceil(CH/4) float4s the blend uses (blend_packed.cu, kW4), from a
    256-byte-aligned start, so whole 32-byte sectors: 128 / 160 / 256 B at
    CH = 19 / 32 / 51."""
    return -(-16 * (2 + -(-ch // 4)) // 32) * 32


def k2_bound(offsets, payload_rows: int, rows: int, hits: int, ch: int, num_tiles: int):
    """K2's bound on this data: 15 ops per pair-pixel of every row up to count
    (recomputing alpha, no early-out), and per pair-pixel that passes the cut
    the <g, c> dot product (2·CH), the CH colour terms, the 6 + CH sums over the
    tile's pixels and about 30 more for the transmittance, prefix and geometry
    terms (4·CH + 36). Bytes: the rows read, the whole d_payload written, img,
    g_img, alpha, g_alpha, offsets and bg read."""
    from segsplat_tpu_torch.ops.blend import payload_width

    w = payload_width(ch) * 4
    ops = rows * 256 * 15 + hits * (4 * ch + 36)
    bytes_ = (rows * w + payload_rows * w + num_tiles * 256 * (2 * ch + 2) * 4
              + offsets.numel() * 4 + ch * 4)
    return _bound(ops, bytes_) + (ops, bytes_)


def phase_full(results):
    import torch

    from segsplat_tpu_torch.ops.blend import (blend_tiles, blend_tiles_plain,
                                              blend_tiles_plain_with_work, blend_tiles_warp_rows)
    from segsplat_tpu_torch.ops.rasterize import (build_blend_inputs, project_gaussians,
                                                  rasterize)

    W, H = FRAME_W, FRAME_H
    cam = bench_camera(W, H)
    vm, fx, fy, cx, cy = cam
    for name, make in (("headline", headline_scene), ("hostile", hostile_scene)):
        sc = make()
        m, K, cap = sc["m"], sc["K"], sc["pair_cap"]
        t, bi = blend_inputs_on_card(sc, W, H, cam, m, K, pair_cap=cap)
        bg = torch.zeros(32, device="cuda")
        got = blend_tiles(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
        ref_img, ref_alpha, rows, hits, stopped = blend_tiles_plain_with_work(
            bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
        torch.cuda.synchronize()
        err = compare(name, got, (ref_img, ref_alpha))
        results["fwd_err"] = max(results["fwd_err"], err)
        del got, ref_img, ref_alpha
        lists = warp_row_shares(f"{name} K1", blend_tiles_warp_rows(
            bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K))

        blend = lambda: blend_tiles(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
        plain = lambda: blend_tiles_plain(bi.offsets, bi.sorted_payload, bg,
                                          bi.tx_n, bi.ty_n, K)
        vm_t = torch.as_tensor(vm, device="cuda")
        raster = lambda: rasterize(t["xyz"], t["scales"], t["quats"], t["opac"],
                                   t["colors"], vm_t, fx, fy, cx, cy, W, H, bg=bg,
                                   max_tiles_per_axis=m, max_per_tile=K, pair_cap=cap)
        project = lambda: project_gaussians(t["xyz"], t["scales"], t["quats"], vm_t,
                                            fx, fy, cx, cy, W, H)
        proj = project()
        binning = lambda: build_blend_inputs(proj, t["colors"], t["opac"], W, H, m, K,
                                             pair_cap=cap)
        ms = cuda_time_ms(blend, reps=10)
        plain_ms = cuda_time_ms(plain, reps=3, warmup=1)
        raster_ms = cuda_time_ms(raster, reps=5)
        project_ms = cuda_time_ms(project, reps=5)
        bin_ms = cuda_time_ms(binning, reps=5)
        bound_ms, bound_by, ops, bytes_ = k1_bound(bi.offsets, rows, hits, 32,
                                                    bi.tx_n * bi.ty_n)
        scene = dict(num_pairs=int(bi.num_pairs), pair_cap=cap,
                     tile_overflow=int(bi.tile_overflow), rows_read=rows,
                     pixels_hit=hits, tiles_stopped=stopped, K=K, m=m,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, rasterize_ms=raster_ms,
                     project_ms=project_ms, bin_gather_ms=bin_ms,
                     bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=bytes_, **lists)
        results["scenes"][name] = scene
        log(f"[full] {name}: " + json.dumps(scene))
        if name == "headline":
            results["k2_32"] = k2_on_frame(results, t, bi, bg, cam, W, H, m, K, cap)
            log("[full] headline K2 CH=32: " + json.dumps(results["k2_32"]))
        del t, bi
        torch.cuda.empty_cache()


def k2_on_frame(results, t, bi, bg, cam, W, H, m, K, cap):
    """K2 at 32 channels on a 1080p frame: the gradient of a seeded linear
    functional of rasterize's image, whose backward launches K2 (counted), then
    K2 on the frame's blend inputs and that cotangent against its plain
    version, timed, with its bound."""
    import torch

    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops.rasterize import rasterize

    vm, fx, fy, cx, cy = cam
    gen = torch.Generator(DEV).manual_seed(3)
    w = torch.randn((H, W, 32), generator=gen, device=DEV)
    colors = t["colors"].detach().requires_grad_(True)
    B.blend_tiles_bwd.launches = 0
    out = rasterize(t["xyz"], t["scales"], t["quats"], t["opac"], colors,
                    torch.as_tensor(vm, device=DEV), fx, fy, cx, cy, W, H, bg=bg,
                    max_tiles_per_axis=m, max_per_tile=K, pair_cap=cap)
    (out["image"] * w).sum().backward()
    torch.cuda.synchronize()
    launches = B.blend_tiles_bwd.launches
    if launches < 1 or not bool(colors.grad.abs().max() > 0):
        raise AssertionError(f"the frame's gradient launched K2 {launches} times")
    del out, colors

    img, alpha = B.blend_tiles_plain(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
    g_img = torch.zeros_like(img)
    g_img[:H, :W] = w                    # the cotangent rasterize hands the blend
    bargs = (bi.offsets, bi.sorted_payload, bg, img, alpha, g_img, torch.zeros_like(alpha),
             bi.tx_n, bi.ty_n, K)
    d_pay, d_bg = B.blend_tiles_bwd(*bargs)
    r_pay, r_bg, rows, hits = B.blend_tiles_bwd_plain_with_work(*bargs)
    err = max(compare_grad("headline K2 d_payload", d_pay, r_pay),
              compare_grad("headline K2 d_bg", d_bg, r_bg))
    results["bwd_err"] = max(results["bwd_err"], err)
    del d_pay, r_pay
    stats = dict(launches=launches, max_abs_err=err, rows_read=rows, pixels_hit=hits,
                 ms=cuda_time_ms(lambda: B.blend_tiles_bwd(*bargs), reps=10),
                 plain_ms=cuda_time_ms(lambda: B.blend_tiles_bwd_plain(*bargs), reps=3,
                                       warmup=1))
    stats["bound_ms"], stats["bound_by"], stats["ops"], stats["bytes"] = k2_bound(
        bi.offsets, bi.sorted_payload.shape[0], rows, hits, 32, bi.tx_n * bi.ty_n)
    return stats


def write_model_dir(root: str, n_views: int = 4):
    """A Blender-style scene + trained-model dir holding the headline Gaussians
    and a 32-prompt semantics .npz. Returns (model_path, semantics_path, scene)."""
    from argparse import Namespace

    import numpy as np
    from PIL import Image

    from segsplat_tpu_torch.io.artifacts import save_semantics
    from segsplat_tpu_torch.io.dataset import store_point_cloud_ply
    from segsplat_tpu_torch.io.ply import save_gaussian_ply

    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    os.makedirs(src)
    frames = []
    for i in range(n_views):
        a = 0.002 * i           # small yaw steps, camera at the origin
        c2w = np.eye(4)
        c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]]
        c2w[:3, 1:3] *= -1      # COLMAP → Blender camera axes
        Image.new("RGB", (1920, 1080)).save(os.path.join(src, f"r_{i}.png"))
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(src, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 1.2, "frames": frames}, f)
    store_point_cloud_ply(os.path.join(src, "points3d.ply"),
                          np.zeros((8, 3), np.float32), np.zeros((8, 3), np.uint8))

    sc = headline_scene()
    n = sc["xyz"].shape[0]
    op = sc["opac"].astype(np.float64)
    save_gaussian_ply(
        os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"),
        xyz=sc["xyz"], features_dc=np.zeros((n, 1, 3), np.float32),
        features_rest=np.zeros((n, 15, 3), np.float32),
        opacity=np.log(op / (1.0 - op)).astype(np.float32),
        scaling=np.log(sc["scales"]), rotation=sc["quats"])
    sem = os.path.join(root, "gaussian_semantics.npz")
    save_semantics(sem, labels=sc["colors"].argmax(1), logits=sc["colors"],
                   prompts=[f"class_{i}" for i in range(32)])
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(repr(Namespace(source_path=src, model_path=model, images="images",
                               object_path="object_mask", resolution=1,
                               white_background=False, sh_degree=3, eval=False)))
    return model, sem


def phase_main_path(results, root: str):
    """The semantic render path through its CLI twin."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import render_semantics_logits as cli
    from segsplat_tpu_torch.ops.blend import blend_tiles, blend_tiles_bwd, blend_tiles_plain
    from segsplat_tpu_torch.ops.rasterize import build_blend_inputs, project_gaussians
    from segsplat_tpu_torch.pipeline.render_semantics import attach_logits_for_table
    from segsplat_tpu_torch.scene import Scene, to_device_camera

    n_views = 4
    model, sem = write_model_dir(root, n_views)
    argv = ["--model_path", model, "--iteration", "1", "--semantics", sem,
            "--skip_test", "--resolution", "1", "--device", "cuda"]
    stdout = sys.stdout         # the CLI's safe_state timestamps stdout lines
    blend_tiles.launches = blend_tiles_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdout = stdout
    launches = blend_tiles.launches
    results["launches"]["render_semantics"] = {"blend_fwd": launches,
                                               "blend_bwd": blend_tiles_bwd.launches}
    results["cli_s"] = time.perf_counter() - t0
    if launches < n_views:
        raise AssertionError(f"main path launched the blend kernel {launches} "
                             f"times for {n_views} views")

    out_dir = os.path.join(model, "train", "ours_1", "semantics")
    for i in range(n_views):
        for suffix in ("_labels.pt", "_logits.npy", "_mask_color.png", "_confidence.png"):
            p = os.path.join(out_dir, f"{i:05d}{suffix}")
            if not os.path.exists(p):
                raise AssertionError(f"main path wrote no {p}")
    saved = np.load(os.path.join(out_dir, "00000_logits.npy")).astype(np.float32)
    if saved.shape != (32, 1080, 1920) or not np.isfinite(saved).all():
        raise AssertionError(f"view 0 logits: shape {saved.shape}, finite "
                             f"{np.isfinite(saved).all()}")

    # view 0 again, blended by the plain version on the same loaded inputs
    scene = Scene(os.path.join(root, "scene"), model, shuffle=False,
                  load_iteration=1, device="cuda")
    table = scene.gaussians
    cam = to_device_camera(scene.get_train_cameras()[0], 1.0, device="cuda")
    logits = torch.as_tensor(attach_logits_for_table(table, sem), device="cuda")
    K = cam.intrinsics()
    proj = project_gaussians(table.xyz, table.get_scaling(), table.get_rotation(),
                             cam.world_view_transform(), K[0, 0], K[1, 1], K[0, 2],
                             K[1, 2], cam.width, cam.height)
    opac = table.get_opacity()[:, 0] * table.active.float()
    bi = build_blend_inputs(proj, logits, opac, cam.width, cam.height, 6, 256,
                            pair_cap=min(table.capacity * 36, 3_000_000))
    ref, _ = blend_tiles_plain(bi.offsets, bi.sorted_payload,
                               torch.zeros(32, device="cuda"), bi.tx_n, bi.ty_n, 256)
    ref = ref[:1080, :1920].permute(2, 0, 1).cpu().numpy()
    # the CLI stores fp16: allow its rounding (2^-11 relative) on top of 1e-4
    fp16_err = float(np.abs(saved - ref).max())
    if not np.all(np.abs(saved - ref) <= 1e-4 + np.abs(ref) * 2.0 ** -10):
        raise AssertionError(f"view 0 logits differ from the plain blend by {fp16_err}")
    labels = torch.load(os.path.join(out_dir, "00000_labels.pt"),
                        weights_only=True)["label_indices"].numpy()
    top2 = np.sort(ref, axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 1e-2
    if not np.array_equal(labels[clear], ref.argmax(0)[clear]):
        raise AssertionError("view 0 labels differ from the plain blend's argmax")
    log(f"[main] CLI rendered {n_views} views at 1920x1080 in "
        f"{results['cli_s']:.3f} s; blend launches {launches}; view 0 logits vs "
        f"plain max abs diff {fp16_err:.3g} (fp16 file); labels equal on "
        f"{int(clear.sum())} px with top1-top2 > 1e-2")


# ───────────────────────────── training (phases 5–6) ───────────────────────────

TRAIN_W, TRAIN_H, TRAIN_CAP, TRAIN_N = 876, 584, 262_144, 200_000
DEV = "cuda"
TRAIN_ITERS = 20


def train_scene():
    """scripts/perf_train.py:37-63, seed 0: the point cloud and its colours, a
    GT image and 32 mask ids, drawn in that script's order."""
    import numpy as np

    rng = np.random.default_rng(0)
    pts = (rng.random((TRAIN_N, 3)) * np.array([4.0, 3.0, 4.0])
           + np.array([-2.0, -1.5, 2.0])).astype(np.float32)
    cols = rng.random((TRAIN_N, 3)).astype(np.float32)
    gt = rng.random((3, TRAIN_H, TRAIN_W)).astype(np.float32)
    gto = rng.integers(0, 32, (TRAIN_H, TRAIN_W)).astype(np.int32)
    return pts, cols, gt, gto


def train_camera(yaw: float):
    """scripts/perf_train.py's cam_of: a yaw about the origin, fov 1.2 × 0.75."""
    import numpy as np
    import torch

    from segsplat_tpu_torch.core.types import Camera

    R = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                  [-math.sin(yaw), 0, math.cos(yaw)]], np.float32)
    f32 = dict(dtype=torch.float32, device=DEV)
    return Camera(R=torch.as_tensor(R, **f32), T=torch.zeros(3, **f32),
                  fov_x=torch.tensor(1.2, **f32), fov_y=torch.tensor(0.75, **f32),
                  width=TRAIN_W, height=TRAIN_H)


@contextlib.contextmanager
def swapped(module, **replacements):
    """Replace module attributes for the duration (timing wrappers, or the
    plain blend for a reference step); restores them after."""
    old = {k: getattr(module, k) for k in replacements}
    for k, v in replacements.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def blend_node(total):
    """The blend's autograd node in the graph of ``total``."""
    seen, stack = set(), [total.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_BlendBackward":
            return node
        stack.extend(f for f, _ in node.next_functions)
    raise AssertionError("the step's graph has no blend node")


def kernels_on_captured(results, cap, label: str):
    """K1 and K2 on a blend node's own inputs and cotangents (captured by a
    prehook), against their plain versions, timed with CUDA events, with their
    bounds. Returns (fwd, bwd) stats."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    offsets, payload, bg, img, alpha = (t.detach() for t in cap["saved"])
    tx_n, ty_n, K = cap["dims"]
    ch = bg.shape[0]
    # a loss that does not read alpha gets zeros there from autograd
    g_img, g_alpha = (torch.zeros_like(x) if g is None else g.detach().contiguous()
                      for g, x in zip(cap["grads"], (img, alpha)))
    fargs = (offsets, payload, bg, tx_n, ty_n, K)
    f_got = B.blend_tiles(*fargs)
    f_img, f_alpha, f_rows, f_hits, _ = B.blend_tiles_plain_with_work(*fargs)
    fwd_err = compare(f"{label} K1 CH={ch}", f_got, (f_img, f_alpha))
    results["fwd_err"] = max(results["fwd_err"], fwd_err)
    del f_got, f_img, f_alpha
    bargs = (offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K)
    b_pay, b_bg = B.blend_tiles_bwd(*bargs)
    r_pay, r_bg, b_rows, b_hits = B.blend_tiles_bwd_plain_with_work(*bargs)
    bwd_err = max(compare_grad(f"{label} K2 CH={ch} d_payload", b_pay, r_pay),
                  compare_grad(f"{label} K2 CH={ch} d_bg", b_bg, r_bg))
    results["bwd_err"] = max(results["bwd_err"], bwd_err)
    del b_pay, r_pay
    num_tiles = tx_n * ty_n
    fwd = dict(ms=cuda_time_ms(lambda: B.blend_tiles(*fargs), reps=10),
               plain_ms=cuda_time_ms(lambda: B.blend_tiles_plain(*fargs), reps=3, warmup=1),
               rows_read=f_rows, pixels_hit=f_hits, max_abs_err=fwd_err,
               **warp_row_shares(f"{label} K1 CH={ch}", B.blend_tiles_warp_rows(*fargs)))
    fwd["bound_ms"], fwd["bound_by"], fwd["ops"], fwd["bytes"] = k1_bound(
        offsets, f_rows, f_hits, ch, num_tiles)
    bwd = dict(ms=cuda_time_ms(lambda: B.blend_tiles_bwd(*bargs), reps=10),
               plain_ms=cuda_time_ms(lambda: B.blend_tiles_bwd_plain(*bargs), reps=3,
                                     warmup=1),
               rows_read=b_rows, pixels_hit=b_hits, payload_rows=int(payload.shape[0]),
               max_abs_err=bwd_err)
    bwd["bound_ms"], bwd["bound_by"], bwd["ops"], bwd["bytes"] = k2_bound(
        offsets, payload.shape[0], b_rows, b_hits, ch, num_tiles)
    log(f"[{label}] K1 CH={ch} at {TRAIN_W}x{TRAIN_H}: " + json.dumps(fwd))
    log(f"[{label}] K2 CH={ch} at {TRAIN_W}x{TRAIN_H}: " + json.dumps(bwd))
    return fwd, bwd


def capture_blend(total, cap: dict):
    """Have ``total``'s backward record its blend node's residuals, dims and
    incoming cotangents into ``cap``."""
    node = blend_node(total)
    node.register_prehook(lambda g: cap.update(saved=node.saved_tensors, dims=node.dims,
                                               grads=g))


def phase_train_step(results):
    import torch

    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.train import losses as L
    from segsplat_tpu_torch.train import trainer as T
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    pts, cols, gt_np, gto_np = train_scene()
    t0 = time.perf_counter()
    table = T.init_table_from_pcd(pts, cols, TRAIN_CAP, max_sh_degree=3, seed=0,
                                  device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = T.OptimizationConfig(num_classes=256)
    state = T.init_state(table, cfg, spatial_lr_scale=3.0, seed=0)
    raster_kw = dict(max_tiles_per_axis=3, max_per_tile=256)
    gt = torch.as_tensor(gt_np, device=DEV)
    gto = torch.as_tensor(gto_np, device=DEV)
    bg = torch.zeros(3, device=DEV)
    gen = torch.Generator(DEV).manual_seed(0)
    idx = torch.randint(0, TRAIN_W * TRAIN_H, (32768,), generator=gen, device=DEV)
    tensors = [getattr(state.table, f) for f in PARAM_FIELDS] + [state.code_book]

    def step1(plain: bool):
        """Step 1's losses and gradients, and the blend's inputs and cotangents."""
        for t in tensors:
            t.grad = None
        offset = torch.zeros((TRAIN_CAP, 2), device=DEV, requires_grad=True)
        captured = {}
        ctx = (swapped(B, blend_tiles=B.blend_tiles_plain,
                       blend_tiles_bwd=B.blend_tiles_bwd_plain)
               if plain else contextlib.nullcontext())
        with ctx:
            total, aux = T.compute_losses(state.table, state.code_book, train_camera(0.0),
                                          gt, gto, bg, cfg, offset, raster_kw, idx=idx)
            capture_blend(total, captured)
            total.backward()
        torch.cuda.synchronize()
        grads = {f: getattr(state.table, f).grad.clone() for f in PARAM_FIELDS}
        grads["code_book"] = state.code_book.grad.clone()
        grads["means2d_offset"] = offset.grad.clone()
        terms = {k: float(aux[k].detach()) for k in T.METRIC_KEYS}
        return grads, terms, captured

    got, got_terms, cap = step1(plain=False)
    ref, ref_terms, _ = step1(plain=True)
    for k, v in ref_terms.items():
        if not (math.isfinite(got_terms[k]) and
                abs(got_terms[k] - v) <= 1e-4 * abs(v) + 1e-9):
            raise AssertionError(f"step 1 {k}: kernels {got_terms[k]} vs plain {v}")
    grad_err = {k: compare_grad(f"step 1 grad {k}", got[k], ref[k]) for k in ref}
    # at SH degree 0 the higher bands get no gradient; with the initial
    # isotropic scales the covariance does not depend on the rotation; and
    # perf_train's mask ids are per-pixel noise, so no pixel is confident and the
    # codebook's two losses are 0
    for k, g in got.items():
        if k not in ("features_rest", "rotation", "code_book") and not bool((g != 0).any()):
            raise AssertionError(f"step 1 grad {k} is identically zero")
    del got, ref
    log(f"[train] step 1, kernels vs plain: loss terms {json.dumps(got_terms)}; "
        f"grad max abs diff {json.dumps(grad_err)}")

    # K1 (19 channels) and K2 on the step's own blend inputs and cotangents
    results["train_fwd"], results["train_bwd"] = kernels_on_captured(results, cap, "train")
    del cap

    # the step, timed part by part: CUDA events around the render, the losses
    # (compute_losses less the render) and the optimizers; the backward is the
    # rest of the step; the LAP on the host clock
    spans, lap_ms = {}, []

    def timed(name, fn):
        def run(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans.setdefault(name, []).append(ev)
            return out
        return run

    host_lap = L.linear_sum_assignment

    def lap(*a, **k):
        t = time.perf_counter()
        out = host_lap(*a, **k)
        lap_ms.append((time.perf_counter() - t) * 1e3)
        return out

    step_fn = T.make_train_step(cfg, raster_kw)
    warm, timed_steps = 2, 10
    rows, wall = [], []
    with swapped(T, render=timed("render", T.render),
                 compute_losses=timed("compute_losses", T.compute_losses),
                 apply_updates=timed("optimizers", T.apply_updates)), \
            swapped(L, linear_sum_assignment=lap):
        for i in range(warm + timed_steps):
            spans.clear()
            lap_ms.clear()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            ev[0].record()
            m = step_fn(state, train_camera(0.01 * i), gt, gto, bg, generator=gen)
            ev[1].record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            if not all(math.isfinite(float(v)) for v in m.values()):
                raise AssertionError(f"train step {i}: non-finite metrics {m}")
            span = {k: v[0][0].elapsed_time(v[0][1]) for k, v in spans.items()}
            step = ev[0].elapsed_time(ev[1])
            rows.append(dict(step=step, render=span["render"],
                             losses=span["compute_losses"] - span["render"],
                             lap_host=sum(lap_ms), optimizers=span["optimizers"],
                             backward=step - span["compute_losses"] - span["optimizers"]))
    med = {k: statistics.median(r[k] for r in rows[warm:]) for k in rows[0]}
    med["wall"] = statistics.median(wall[warm:])
    results["train_step"] = dict(
        median_ms=med, steps=timed_steps, init_table_s=init_s,
        num_pairs=int(m["num_pairs"]), tile_overflow=int(m["tile_overflow"]),
        total=float(m["total"]), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[train] step at {TRAIN_W}x{TRAIN_H}, capacity {TRAIN_CAP}, {TRAIN_N} Gaussians, "
        f"m=3, K=256: " + json.dumps(results["train_step"]))
    del state, table
    torch.cuda.empty_cache()


def write_train_scene(root: str, n_views: int = 3) -> str:
    """A Blender-style scene of perf_train's point cloud seen from the origin:
    ``n_views`` noise images at 876×584 and the 200 000-point ``points3d.ply``."""
    import numpy as np
    from PIL import Image

    from segsplat_tpu_torch.io.dataset import store_point_cloud_ply

    pts, cols, _, _ = train_scene()
    rng = np.random.default_rng(1)
    os.makedirs(root)
    frames = []
    for i in range(n_views):
        a = 0.01 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]]
        c2w[:3, 1:3] *= -1      # COLMAP → Blender camera axes
        img = (rng.random((TRAIN_H, TRAIN_W, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"r_{i}.png"))
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 1.2, "frames": frames}, f)
    store_point_cloud_ply(os.path.join(root, "points3d.ply"), pts,
                          (cols * 255).astype(np.uint8))
    return root


def phase_train_cli(results, root: str):
    import numpy as np
    import torch

    from segsplat_tpu_torch.ops.blend import blend_tiles, blend_tiles_bwd
    from segsplat_tpu_torch.scene import load_gaussian_table
    from segsplat_tpu_torch.train import cli

    src = write_train_scene(os.path.join(root, "train_scene"))
    model = os.path.join(root, "train_model")
    # a densify step at 10 (inside (5, 20)), an opacity reset at 15, then eval,
    # save and a checkpoint at 20
    argv = ["-s", src, "-m", model, "--iterations", str(TRAIN_ITERS),
            "--capacity", str(TRAIN_CAP), "--densify_from_iter", "5",
            "--densification_interval", "10", "--densify_until_iter", str(TRAIN_ITERS),
            "--opacity_reset_interval", "15", "--test_iterations", str(TRAIN_ITERS),
            "--checkpoint_iterations", str(TRAIN_ITERS), "--device", DEV]
    stdout = sys.stdout         # the CLI's safe_state timestamps stdout lines
    blend_tiles.launches = blend_tiles_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        state = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdout = stdout
    launches = {"blend_fwd": blend_tiles.launches, "blend_bwd": blend_tiles_bwd.launches}
    results["launches"]["train"] = launches
    cli_s = time.perf_counter() - t0
    if min(launches.values()) < TRAIN_ITERS:
        raise AssertionError(f"{TRAIN_ITERS} training iterations launched {launches}")

    metrics = [json.loads(line) for line in open(os.path.join(model, "metrics.jsonl"))]
    steps = [m for m in metrics if "total" in m]
    evals = [m for m in metrics if "eval_psnr" in m]
    if len(steps) != TRAIN_ITERS // 10 or not evals:
        raise AssertionError(f"metrics.jsonl holds {len(steps)} step and {len(evals)} "
                             f"eval records")
    bad = [(m["iter"], k) for m in steps + evals for k, v in m.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    ply = os.path.join(model, "point_cloud", f"iteration_{TRAIN_ITERS}", "point_cloud.ply")
    reloaded = load_gaussian_table(ply, capacity=TRAIN_CAP, device=DEV)
    active = state.table.active
    if int(reloaded.active.sum()) != int(active.sum()) or not torch.equal(
            reloaded.xyz[:int(active.sum())], state.table.xyz.detach()[active]):
        raise AssertionError("the saved PLY does not reload into the trained table")
    ckpt = os.path.join(model, "chkpnts", f"chkpnt{TRAIN_ITERS}.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"no checkpoint {ckpt}")
    results["train_cli"] = dict(
        seconds=cli_s, launches=launches, last=steps[-1], eval=evals[-1],
        num_gaussians=int(active.sum()))
    log(f"[train-cli] {TRAIN_ITERS} iterations at {TRAIN_W}x{TRAIN_H} through "
        f"segsplat_tpu_torch.train in {cli_s:.1f} s: launches {launches}; last "
        f"{json.dumps(steps[-1])}; eval {json.dumps(evals[-1])}; PLY reloads with "
        f"{int(active.sum())} active rows")


# ──────────────── phase 7: the 51-channel render, K3, the dense blend ────────────────

LOGIT_OUTPUTS = (("render", 3), ("render_object", 16), ("semantic_logits", 32))


def phase_logits_render(results):
    """(a) ``render(..., semantic_logits=...)`` of phase 5's table: forward and
    the gradient of a seeded linear functional with K1 and K2 at 51 channels
    against the same calls with the plain blends; K1 and K2 timed on the blend
    node's own inputs and cotangents."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import render as R
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.train import trainer as T
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    pts, cols, _, _ = train_scene()
    table = T.init_table_from_pcd(pts, cols, TRAIN_CAP, max_sh_degree=3, seed=0,
                                  device=DEV)
    rng = np.random.default_rng(5)
    logits = torch.as_tensor(rng.standard_normal((TRAIN_CAP, 32), dtype=np.float32),
                             device=DEV).requires_grad_(True)
    weights = {k: torch.as_tensor(rng.standard_normal((c, TRAIN_H, TRAIN_W),
                                                      dtype=np.float32), device=DEV)
               for k, c in LOGIT_OUTPUTS}
    leaves = {f: getattr(table, f).requires_grad_(True) for f in PARAM_FIELDS}
    leaves["logits"] = logits
    cam, bg = train_camera(0.0), torch.zeros(3, device=DEV)
    k1, k2 = B.blend_tiles, B.blend_tiles_bwd

    def run(plain: bool):
        for t in leaves.values():
            t.grad = None
        cap = {}
        ctx = (swapped(B, blend_tiles=B.blend_tiles_plain,
                       blend_tiles_bwd=B.blend_tiles_bwd_plain)
               if plain else contextlib.nullcontext())
        k1.launches = k2.launches = 0
        with ctx:
            out = R.render(table, cam, bg, semantic_logits=logits,
                           max_tiles_per_axis=3, max_per_tile=256)
            total = sum((weights[k] * out[k]).sum() for k, _ in LOGIT_OUTPUTS)
            capture_blend(total, cap)
            total.backward()
        torch.cuda.synchronize()
        launches = {"blend_fwd": k1.launches, "blend_bwd": k2.launches}
        fwd = [out[k].detach() for k, _ in LOGIT_OUTPUTS] + [out["alpha"].detach()]
        grads = {k: t.grad.clone() for k, t in leaves.items()}
        return fwd, grads, cap, launches

    got, got_grads, cap, launches = run(plain=False)
    ref, ref_grads, _, plain_launches = run(plain=True)
    if min(launches.values()) < 1 or max(plain_launches.values()) > 0:
        raise AssertionError(f"the 51-channel render launched {launches} with the "
                             f"kernels and {plain_launches} with the plain blends")
    if got[2].shape != (32, TRAIN_H, TRAIN_W):
        raise AssertionError(f"semantic_logits has shape {tuple(got[2].shape)}")
    fwd_err = compare("render(semantic_logits) forward", got, ref)
    grad_err = {k: compare_grad(f"render(semantic_logits) grad {k}", got_grads[k],
                                ref_grads[k]) for k in ref_grads}
    for k in ("xyz", "features_dc", "scaling", "opacity", "objects_dc", "logits"):
        if not bool((got_grads[k] != 0).any()):
            raise AssertionError(f"render(semantic_logits) grad {k} is identically zero")
    del got, ref, got_grads, ref_grads
    log(f"[logits] render(semantic_logits) at {TRAIN_W}x{TRAIN_H}: launches "
        f"{json.dumps(launches)}; forward vs plain max abs diff {fwd_err:.3g}; grad "
        f"max abs diff {json.dumps(grad_err)}")
    fwd, bwd = kernels_on_captured(results, cap, "logits")
    results["logits_render"] = dict(launches=launches, forward_err=fwd_err,
                                    grad_err=grad_err, fwd=fwd, bwd=bwd)
    # (b) K3 on this render's 51-channel payload: pack the captured K1 rows
    offsets, payload = (t.detach() for t in cap["saved"][:2])
    tx_n, ty_n, K = cap["dims"]
    packed = B.pack_payload(payload[:-K], K)
    with torch.no_grad():
        results["packed"]["logits51"] = packed_stats(
            "logits51", lambda: R.render(table, cam, bg, semantic_logits=logits,
                                         max_tiles_per_axis=3, max_per_tile=256),
            (offsets, packed, torch.zeros(51, device=DEV), tx_n, ty_n, K),
            (offsets, payload, torch.zeros(51, device=DEV), tx_n, ty_n, K))
    del cap, table, leaves, logits
    torch.cuda.empty_cache()


def packed_stats(name, raster, pargs, dargs):
    """K3 through ``rasterize`` with USE_PACKED on (``raster()`` renders; its
    count is the launches), then on the same frame's packed payload ``pargs``
    against its plain version at 1e-4 and against K1 on the K1 payload
    ``dargs`` at ``packed_atol``; timed with its bound."""
    import torch

    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops import rasterize as Rz

    with swapped(Rz, USE_PACKED=True):
        B.blend_tiles_packed.launches = 0
        out = raster()
        torch.cuda.synchronize()
        launches = B.blend_tiles_packed.launches
        raster_ms = cuda_time_ms(raster, reps=5)
    if launches < 1:
        raise AssertionError(f"{name}: rasterize with USE_PACKED launched K3 {launches} times")
    img = out["image"] if "image" in out else torch.cat(
        [out[k].permute(1, 2, 0) for k, _ in LOGIT_OUTPUTS], dim=2)
    h, w = img.shape[:2]
    del out

    got = B.blend_tiles_packed(*pargs)
    ref_img, ref_alpha, rows, hits, stopped = B.blend_tiles_packed_plain_with_work(*pargs)
    torch.cuda.synchronize()
    err = compare(f"{name} K3", got, (ref_img, ref_alpha))
    compare(f"{name} rasterize(USE_PACKED) image", [img], [got[0][:h, :w]])
    k1_img, k1_alpha, _, _, k1_stopped = B.blend_tiles_plain_with_work(*dargs)
    k1_err = compare(f"{name} K3 vs K1", got, (k1_img, k1_alpha),
                     atol=packed_atol(dargs[1], dargs[2]))
    del got, ref_img, ref_alpha, k1_img, k1_alpha, img
    offsets, ch, num_tiles = pargs[0], pargs[2].shape[0], pargs[3] * pargs[4]
    stats = dict(launches=launches, max_abs_err=err, vs_k1_max_abs_err=k1_err, ch=ch,
                 rows_read=rows, pixels_hit=hits, tiles_stopped=stopped,
                 k1_tiles_stopped=k1_stopped,
                 ms=cuda_time_ms(lambda: B.blend_tiles_packed(*pargs), reps=10),
                 plain_ms=cuda_time_ms(lambda: B.blend_tiles_packed_plain(*pargs), reps=3,
                                       warmup=1),
                 rasterize_ms=raster_ms,
                 **warp_row_shares(f"{name} K3", B.blend_tiles_packed_warp_rows(*pargs)))
    stats["bound_ms"], stats["bound_by"], stats["ops"], stats["bytes"] = k1_bound(
        offsets, rows, hits, ch, num_tiles, row_bytes=k3_row_bytes(ch))
    log(f"[packed] {name}: " + json.dumps(stats))
    return stats


def phase_other_blends(results):
    """(b) K3 through rasterize's packed branch on the 1080p headline and
    hostile scenes; (c) the dense backend on the headline scene against K1."""
    import torch

    from segsplat_tpu_torch.ops.rasterize import rasterize

    W, H = FRAME_W, FRAME_H
    cam = bench_camera(W, H)
    vm, fx, fy, cx, cy = cam
    vm_t = torch.as_tensor(vm, device=DEV)
    bg = torch.zeros(32, device=DEV)
    for name, make in (("headline", headline_scene), ("hostile", hostile_scene)):
        sc = make()
        m, K, cap = sc["m"], sc["K"], sc["pair_cap"]
        t, bi = blend_inputs_on_card(sc, W, H, cam, m, K, pair_cap=cap)
        _, pbi = blend_inputs_on_card(sc, W, H, cam, m, K, pair_cap=cap, packed=True)
        raster = lambda backend="cuda": rasterize(
            t["xyz"], t["scales"], t["quats"], t["opac"], t["colors"], vm_t, fx, fy, cx,
            cy, W, H, bg=bg, max_tiles_per_axis=m, max_per_tile=K, pair_cap=cap,
            backend=backend)
        with torch.no_grad():
            results["packed"][name] = packed_stats(
                name, raster, (pbi.offsets, pbi.sorted_payload, bg, pbi.tx_n, pbi.ty_n, K),
                (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K))
            if name == "headline":
                # K = 256 is one 256-row block: K1 never skips work, as the dense
                # blend does not
                dense, kern = raster("dense"), raster("cuda")
                err = compare("headline dense vs K1", [dense["image"], dense["alpha"]],
                              [kern["image"], kern["alpha"]])
                results["dense"] = dict(max_abs_err=err, ms=cuda_time_ms(
                    lambda: raster("dense"), reps=3, warmup=1), kernel_ms=cuda_time_ms(
                    raster, reps=5))
                log("[dense] headline: " + json.dumps(results["dense"]))
                del dense, kern
        del t, bi, pbi
        torch.cuda.empty_cache()


LIST_KEYS = ("warp_rows_read", "warp_rows_kept", "warp_rows_hit", "kept_share", "hit_share")


def kernel_entry(name, ch, source, replaces, launches, max_abs_err, t, **extra):
    """One kernel's entry of the ``{"kernels": [...]}`` line; K1's and K3's
    carry their row lists' shares from ``t``."""
    return dict(name=name, ch=ch, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None, **{k: t[k] for k in LIST_KEYS if k in t}, **extra)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from segsplat_tpu_torch.utils import cuda_build

    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:     # one nvcc per source, together
        libs = list(ex.map(cuda_build.build_library, KERNELS))
    log(f"[build] {time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(lib.relative_to(cuda_build.BUILD_DIR.parents[1])) for lib in libs))
    for lib in libs:
        log_path = lib.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"[ptxas] {line.strip()}")

    from segsplat_tpu_torch.ops.blend import (KERNEL_CHANNELS, blend_forward_occupancy,
                                              blend_tiles_bwd_occupancy)

    k2_occupancy = {}
    for ch in KERNEL_CHANNELS:
        blocks, smem = blend_tiles_bwd_occupancy(ch)
        k2_occupancy[ch] = dict(blocks_per_sm=blocks, smem_bytes=smem)
    log(f"[occupancy] blend_bwd: {json.dumps(k2_occupancy)}")
    occupancy = {k: {ch: blend_forward_occupancy(k, ch) for ch in KERNEL_CHANNELS}
                 for k in ("blend_fwd", "blend_packed")}
    log(f"[occupancy] {json.dumps(occupancy)}")

    results = {"fwd_err": 0.0, "bwd_err": 0.0, "packed_err": 0.0, "scenes": {},
               "launches": {}, "packed": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for name, phase in (("small", lambda: phase_small(results)),
                            ("full", lambda: phase_full(results)),
                            ("main", lambda: phase_main_path(results, root)),
                            ("train", lambda: phase_train_step(results)),
                            ("train-cli", lambda: phase_train_cli(results, root)),
                            ("logits", lambda: phase_logits_render(results)),
                            ("other-blends", lambda: phase_other_blends(results))):
            t0 = time.perf_counter()
            phase()
            log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    fwd_src, bwd_src, packed_src = (f"segsplat_tpu_torch/csrc/{k}.cu" for k in KERNELS)
    k1_tpu, k2_tpu = ("segsplat_tpu/ops/blend_pallas.py:188",
                      "segsplat_tpu/ops/blend_pallas_vjp.py:195")
    k3_tpu = "segsplat_tpu/ops/blend_pallas2.py:141"
    train_launches = results["launches"]["train"]
    logits, packed = results["logits_render"], results["packed"]
    headline = results["scenes"]["headline"]
    kernels = [
        kernel_entry("blend_fwd", 32, fwd_src, k1_tpu,
                     results["launches"]["render_semantics"]["blend_fwd"],
                     headline["max_abs_err"], headline,
                     path="render_semantics", scenes=results["scenes"],
                     **occupancy["blend_fwd"][32]),
        kernel_entry("blend_fwd", 19, fwd_src, k1_tpu, train_launches["blend_fwd"],
                     results["train_fwd"]["max_abs_err"], results["train_fwd"],
                     path="train", **occupancy["blend_fwd"][19]),
        kernel_entry("blend_fwd", 51, fwd_src, k1_tpu, logits["launches"]["blend_fwd"],
                     logits["fwd"]["max_abs_err"], logits["fwd"],
                     path="render(semantic_logits)", **occupancy["blend_fwd"][51]),
        kernel_entry("blend_bwd", 19, bwd_src, k2_tpu, train_launches["blend_bwd"],
                     results["train_bwd"]["max_abs_err"], results["train_bwd"],
                     path="train", train_step=results["train_step"], **k2_occupancy[19]),
        kernel_entry("blend_bwd", 32, bwd_src, k2_tpu, results["k2_32"]["launches"],
                     results["k2_32"]["max_abs_err"], results["k2_32"],
                     path="rasterize gradient, 1080p headline", **k2_occupancy[32]),
        kernel_entry("blend_bwd", 51, bwd_src, k2_tpu, logits["launches"]["blend_bwd"],
                     logits["bwd"]["max_abs_err"], logits["bwd"],
                     path="render(semantic_logits) gradient", **k2_occupancy[51]),
        kernel_entry("blend_packed", 32, packed_src, k3_tpu,
                     packed["headline"]["launches"] + packed["hostile"]["launches"],
                     max(packed["headline"]["max_abs_err"], packed["hostile"]["max_abs_err"]),
                     packed["headline"], path="rasterize with USE_PACKED",
                     hostile=packed["hostile"], **occupancy["blend_packed"][32]),
        kernel_entry("blend_packed", 51, packed_src, k3_tpu, packed["logits51"]["launches"],
                     packed["logits51"]["max_abs_err"], packed["logits51"],
                     path="render(semantic_logits) with USE_PACKED",
                     **occupancy["blend_packed"][51]),
    ]
    log(f"[total] {time.perf_counter() - t_all:.1f} s on {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
