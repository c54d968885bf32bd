#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (segsplat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: print the card and its power limit; build the four CUDA kernels from
     segsplat_tpu_torch/csrc with nvcc, one process per source, in parallel
     (the three blends at every width of csrc/blend_widths.cuh, and the
     projection).
  2. the card tests: ``python -m pytest --noconftest -p no:cacheprovider -q``
     on CARD_TESTS (tests/test_torch_blend_cuda.py, test_torch_project_cuda.py
     and test_torch_lift_cuda.py) in one child process: K1, K2 and K3 against
     their plain versions on the small scenes of tests/_torch_port.py at every
     width, on degenerate and edge tiles, rasterize on K1 and K2 against the
     dense blend, K1's indexed variant against K1, the projection's forward
     and backward kernels and the lift's card paths. Fails on a non-zero exit or on any skipped case;
     logs the counts of passes, failures and skips.
  3. K1 vs plain at full scale: 1920×1080, 200 000 Gaussians, 32 channels, the
     headline scene (seed 0, m=3, K=256, pair_cap 1.5M) and the hostile one
     (seed 7, m=6, K=512, pair_cap 6M), built as bench.py builds them; times the
     kernel, its plain version and the whole rasterize with CUDA events, and
     reckons the kernel's bound from the rows and pair-pixels this data needs.
     The projection that feeds each blend check, here, in phase 4's view 0
     and in the other phases' blend inputs, runs the projection kernel
     (csrc/project.cu) outside autograd: it must launch once and give
     ``project_gaussians_plain``'s bits in all five outputs. On the headline
     frame the kernel's device time (profiler), the call's and the plain
     version's, host ms a call, and its bound by bytes; also the gradient of
     a seeded linear functional of rasterize's image, which launches K2 at 32
     channels, and K2 on that frame's cotangent against its plain version,
     timed.
  4. the semantic render path through its entry point: the CLI twin
     segsplat_tpu_torch/render_semantics_logits.py renders 4 views at 1080p of a
     model dir written here; K1's and the projection kernel's launch counts
     must reach the views', and view 0's logits must match the plain blend on
     the same inputs.
  5. the full-width train step of scripts/perf_train.py's configuration
     (876×584, capacity 262 144, 200 000 Gaussians from its seed, m=3, K=256,
     256 classes): step 1's loss terms and gradients with K1 + K2 against the
     same step with both plain versions on the card; K1 (19 channels) and K2 vs
     their plain versions on that step's own blend inputs and cotangents, timed,
     with their bounds; the projection's backward kernel (csrc/project.cu's
     ``segsplat_project_bwd``) on the step's table and camera against the
     plain version's autograd backward, timed, with its bound; then 10 steps
     timed with CUDA events, split into forward render, losses, the host LAP,
     backward and optimizers, each launching the projection's forward and
     backward kernels once.
  6. the training path through its entry point: the CLI twin
     ``python -m segsplat_tpu_torch.train`` for 20 iterations on a Blender-style
     scene written here (3 views at 876×584, a 200 000-point cloud, capacity
     262 144), with a densify step and an opacity reset, then eval and save; K1
     and K2 must launch at least once per iteration, the losses must be finite
     and the saved PLY must reload through the port's load_gaussian_table; then
     3 iterations at --max_per_tile 200, no multiple of 128, which must launch
     K1 and K2 each iteration.
  7. the one-pass 51-channel render and the rasterizer's other blend paths:
     (a) ``render(..., semantic_logits=...)`` of phase 5's table (876×584, m=3,
     K=256, seeded [262 144, 32] logits): forward with K1 at 51 channels and the
     gradient of a seeded linear functional of render, render_object and
     semantic_logits with K2 at 51 channels, against the same calls with the
     plain blends; K1 and K2 timed at 51 channels with their bounds;
     (b) the packed kernel K3, which no program path runs, on payloads packed
     here with ``pack_payload`` from the headline and hostile 1080p frames'
     rows (32 channels) and from (a)'s 51-channel render: against its plain
     version at 1e-4 and against K1 at 1e-4 + 2·SAT_EPS·max(|colour|, |bg|),
     timed with its bound;
     (c) the dense backend (the JAX package's "xla") on the headline scene,
     forward, against K1 at 1e-4, timed.
  8. feature lifting, which launches none of the kernels: (a) the DDA and the
     splat lift on the small scenes of tests/test_torch_lift*.py, the DDA
     against the reference kernel's numpy transcription (≥ 99.5 % of pixels),
     the splat against the DDA (≥ 97 %), the card against the CPU (≥ 99.9 %),
     lift_view_splat's sums against hits + scatter_features at rtol 1e-5;
     (b) bench.py's officescene-scale scene in process (876×584 rays, 512
     channels upsampled ×2 from fp16 maps, 109 000 voxels at 0.04 m): 216 views
     (8 cycled) through the splat lift (m=8, K=128) and 16 through the DDA,
     views/s, peak memory, the overflow; the splat at tile_chunk 64, 512 and
     all tiles of a view in one chunk (views/s, peak memory, kernels a view,
     device idle share; counts equal to the default's); per-view medians of
     whole calls (CUDA events), and each stage's device and host time from the
     lift's record_function ranges (torch.profiler, 8 views); one traced view
     of each (kernels launched, device idle share, the costliest kernels),
     splat against DDA at full width (≥ 97 %), and two sweeps of the 8 views
     with the same bits; (c) the lift CLI twin
     segsplat_tpu_torch/aggregate_voxel_features_onthefly.py on those 8 views
     written to disk (its counts must equal (b)'s, its .pt must reload), and
     the grid CLI twin on phase 6's point_cloud.ply at 0.04 m.
  9. the open-vocabulary query, the one-command pipeline and the two models,
     which launch no kernel of their own (the JAX query is XLA): (a) card
     against CPU on small inputs: nearest_neighbor_index (equal indices, or
     near-ties within tests/_torch_port.nn_index_mismatch's bound),
     project_features_to_labels (logits rtol 1e-5, atol 1e-5·scale, labels
     beyond a 1e-3 top-2 gap), the text tower and LSeg on narrow configs (1e-4
     of max|CPU|); (b) the CLIP text tower at its published width (512, 12
     layers, context 77) on 32 prompts, card against CPU and timed; LSeg
     ViT-L/16 + DPT at its published width on a 360×480 image (384×480
     padded) in fp32 and bf16 (ms, peak memory, the least per-pixel cosine of
     bf16 against fp32 ≥ 0.999) and card against CPU in fp32 on a 128×160 image
     (1e-3 of max|CPU|); build_map on phase 6's trained PLY against a
     109 000-voxel table at 0.04 m of seeded 512-channel fp16 features (ms,
     peak memory, the share of 20 000 indices equal to the CPU's); the query
     with run_pipeline.py's 5 prompts and with 32 (device ms of the projection
     and argmax, host ms of the gather, the npz and the two ASCII PLYs);
     (c) the LSeg extraction twin at full width in bf16 on phase 6's views
     (random weights, stamped), the pipeline twin's refusal of those maps, and
     ``python -m segsplat_tpu_torch.run_pipeline`` through all five stages on
     seeded unstamped maps of the same views, K1 launched in stage 5.
  10. pseudo-labels and the LERF-Masked and ScanNet++ evaluation, in three
     phases (lettered from (b); the kernels at every width run in phase 2):
     (b) ``slic``: the pseudo-label loop's GT sweep at 876×584 (K1 at
     3 + 5 and 3 + 20 channels; K1 and K2 timed on a sweep frame's inputs with
     their bounds) and SLIC at prepare_pseudo_label's defaults on the hard
     scene's 30 frames: card against CPU (≥ 99.5 % of labels), the same bits on
     two runs, segment.slic and segment.merge per frame from their profiler
     ranges, one traced frame; (c) ``loop``: ``pseudo_label_loop.run_loop`` at
     results/hard_scene/hard_slic_result.json's configuration (20 objects, 30
     frames at 256², 2 000 iterations, capacity 8 192), every result beside
     the recorded CPU value, tests/test_pseudo_label_loop.py's thresholds, K1
     and K2 launches by stage, K1 and K2 at 19 channels on the trained model's
     render; (d) render_lerf_mask with frame 0's GT mask of one object and
     eval_lerf_mask on (c)'s model; (e) ``mesh``: render_scannetpp_gt on a
     seeded 1 048 576-face room, 8 views at 876×584, one view against the CPU
     (labels equal but at depth ties within 1e-5), eval_scannetpp of the GT
     against itself (mIoU 1.0), and tests/test_miou_loop.py's closed loop
     through K1 at 3 channels (mIoU > 0.8).
  11. ``edit``: object editing, the two inpainters, LPIPS and the offline
     pseudo-label tools: (a) push–pull and PatchMatch (patch 7, 6 × 3
     iterations) on a seeded textured 876×584 frame under a stroke and a
     rectangle hole of eval_inpaint_lpips: card against CPU (push–pull at
     1e-5; PatchMatch's NNF equal at every level and its fill within 1e-5),
     known pixels bit-equal, ms a
     frame, launches and idle share of one traced frame, and the
     inpaint_images twin on that frame and those holes (known pixels kept,
     the hole filled, LPIPS reported); (b) LPIPS vgg and alex
     on a pair of those frames, card against CPU at rtol 1e-4, ms a pair; (d)
     on phase 10c's run, eval_hard_scene_offline.rescore equal to the loop's
     results, eval_hard_scene_checkpoint on its snapshot within 0.05 of them,
     and tune_class_merge's best row beside the recorded one; (c) on phase
     10c's trained hard scene, whose objects render opaque, the removal twin
     on the identity classes lying on its largest GT object (the PLY reloads
     without those rows), hole masks from the removed rows' render (alpha >
     0.5, not all empty), inpaint_images on the 30 views (some pixel
     changed), and the inpaint twin with a 50-step finetune against the fills
     (``--images images_inpaint``): K1 and K2 at least 50
     launches each, the losses finite, frozen rows and the identity features
     bit-unchanged, the new rows moved, the PLY reloads; the finetune step
     timed part by part (render, loss, backward, Adam) and K1/K2 on its own
     inputs.
  12. ``multi``: several devices on torch.distributed, here one NCCL rank on the
     card: (a) ``parallel.multihost.initialize`` at world 1 through a
     ``file://`` rendezvous, its topology; (b) the B-view step
     (``parallel.train.make_parallel_train_step``) at phase 5's configuration
     with B = 4 views at train_camera's yaws on the 1×1 NCCL mesh: step 1's
     losses (1e-4), gradients (rtol 5e-3, atol 2e-4·max|ref|) and updated
     parameters against the same step with both plain blends, its gradient
     against two ranks' shares (views {0,1} and {2,3}) computed in turn and
     added, K1 and K2 exactly 4 launches a step; 10 steps timed by part
     (render, losses, backward, all-reduce, optimizers) beside phase 5's
     single-view step; K1 and K2 on the step's own inputs with their bounds;
     (c) ``torchrun --standalone --nproc_per_node 1`` of the train CLI twin
     with --view_batch 4 for 20 iterations on a 4-view 876×584 scene, with a
     densify step and an opacity reset: K1 and K2 ≥ 4 launches an iteration,
     finite losses, the PLY reloads; --mesh_tensor 2 at world 1 raises; (d)
     ``lift_views_sharded`` at phase 8's officescene scale (8 views, 512
     channels, 109 000 voxels) on the 1×1 mesh against ``lift_views_scan``
     (counts equal, sums 1e-5), and the halves {0..3}, {4..7} lifted in turn
     and added; views/s; (e) the headline scene at 1920×1024 (1080 splits into
     no TILE-aligned strips): ``rasterize_sharded`` on the 1×1 mesh and 4
     strips rendered in turn against the whole frame at 1e-4, each strip and
     the frame timed, K1 on each strip's inputs with its bound.
  13. ``tools``: the SIBR viewer, the host-script twins and check_env: (a)
     ``viewer.NetworkGUI.poll_and_render`` serving clients over loopback from
     phase 5's 200 000-point train table: frames at 876×584 and 1920×1080 at
     scaling_modifier 1.0 and 0.5 (render, host copy and socket ms, bytes), a
     client that pauses training and resumes, one that drops mid-message and
     the next one served; K1 launches equal to the frames served, every frame
     within 1 LSB of the same render on K1's plain version (the bytes that
     differ counted), K1 on the 1080p frame's inputs timed with its bound;
     (b) ``python -m segsplat_tpu_torch.train --port P`` for 10 iterations on
     phase 6's scene with a client fetching one 876×584 frame (K1 ≥ 11
     launches, finite losses), and a second launch on a bound port, which
     warns and trains; (c) on phase 8's work dir (written here when phase 8
     did not run): build_sparse_occupancy, prepare_tensor_data (1 view
     resized to 876×584 × 512 channels), project_features with splat and DDA
     (views/s; indices equal to the CPU's and features within fp16 spacing),
     voxeltovoxel_logits on the splat's voxels and
     aggregate_voxel_colors_onthefly on 1 seeded image, each on the card
     against the CPU, and ``python -m segsplat_tpu_torch.check_env`` in its
     own process (exit 0).
  14. ``scale``: the production run, ``segsplat_tpu_torch.officescene_scale_run``
     at FULL (200 000 Gaussians in a fabricated room, 216 orbit views, one
     [512, 360, 540] fp16 map symlinked for every view): (a) every view
     lifted at 876×584 × 512 channels and every view rendered through K1,
     each stage's time and peak device memory above what it found resident,
     the voxels, the lift's and the render's [WARN]s counted, K1 exactly 216
     launches in stage 5, the host's peak RSS and the bytes written; (b)
     every returned artifact reloads, every label map is [584, 876] in [0,
     13), view 0's logits against the plain blend, view 0's map resized on
     the card and the CPU within 4 ulps of its larger side times its largest
     step (the fp32 source coordinate's rounding), the first 2 views lifted
     on the card and the CPU (counts equal, sums at rtol 1e-5 and an atol of
     a voxel's count times that bound), 20 000 entries of the 1-NN map
     against the CPU's (equal or near-ties), the query against the CPU's
     (logits rtol 1e-5, labels beyond a 1e-3 top-2 gap); (c) stage 5's loop
     traced over 2 views (kernels, device idle share, K1's share); (d) K1 on
     view 0's inputs at the 32 channels stage 5 blends, timed with its bound;
     the work dir removed at the end.
  15. ``measure``: the system's measurement programs, each as ``python -m`` runs it
     at its defaults, in one child process that cannot import JAX, the JAX
     package, scripts/ or tests/: ``segsplat_tpu_torch.bench`` (its one line
     with bench.py's keys less the two lift_baseline ones; K1 and the
     projection kernel exactly once a frame rendered, 96; the hostile scene's largest pair count equal to a
     recount of every bench camera in this process, frame 0's equal to phase
     3's), ``perf_raster_stages`` (its eight lines and "accounted"; K1 128),
     ``perf_bin_dissect`` (its 8 stages; no kernel), ``perf_lift_stages`` (its
     six lines; no kernel) and ``perf_train`` (its line; K1 and K2 once a
     step, 40 each; the projection's forward and backward kernels once a
     step, 40 each, and no backward in the bench or the raster scoreboard).
  16. ``compile``: the blends as registered ops under torch.compile and the
     harness programs: (a) ``graft_entry.entry()``'s frame compiled by
     Inductor with fullgraph, its logits requiring grad: against eager within
     1e-4, K1 once a call, and one backward through it (K2 once, d_payload
     against eager's at rtol 5e-3, atol 2e-4·max|ref|); (b) the 1080p headline
     frame compiled: labels equal to eager's on ≥ 99.99 % of pixels, both pair
     counts, compile seconds, compiled and eager frames timed; (c) ``python -m
     segsplat_tpu_torch.graft_entry`` (its ok lines: the entry, and the dry
     run on 8 gloo ranks with one card) and the CPU half of (d), each a child
     process running while this one compiles (a) and (b); the timings wait for
     them; (d) ``python -m segsplat_tpu_torch.perf_guard`` on the card, alone,
     its counts equal to the ``--device cpu --no-walltime`` run's; (e)
     ``parity_real`` on seeded label maps at 584×876, 3 variants of 8 views.
     It prints phase 15's bench line.
Prints a ``{"kernels": [...]}`` line (each kernel's blocks per SM, shared
memory and registers from the occupancy API; K1's and K3's share of warp-rows
their row lists keep beside the share with a passing lane), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when CUDA
is unavailable or the package is missing. ``--phases`` runs a subset (for
iterating on one phase); it prints no result line and exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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
KERNELS = ("blend_fwd", "blend_bwd", "blend_packed", "project")
PROJECT_BYTES = 73          # a Gaussian: 44 read (t_cam, norm, scales, quats), 29 written
# the backward on the train step's path: 44 read as the forward, 20 of cotangents
# (means2d, conics; depths get none), 44 written (t_cam, norm, scales, quats)
PROJECT_BWD_BYTES = 108
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


def _tests_on_path():
    """Put tests/ on sys.path for its shared scenes (_torch_port, oracles)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


# ───────────────────────────── scenes (numpy, seeded) ─────────────────────────

def bench_scene(name: str) -> dict:
    """bench.py's headline or hostile 1080p scene (segsplat_tpu_torch.bench,
    numpy, seeded), with its m, K and pair cap."""
    from segsplat_tpu_torch import bench

    sc = getattr(bench, f"{name}_render_scene")()
    kw = sc["kw"]
    return dict(sc, m=kw["max_tiles_per_axis"], K=kw["max_per_tile"], pair_cap=kw["pair_cap"])


def bench_camera(W: int = 1920, H: int = 1080):
    """bench.py's camera: identity pose, fov_x 1.2, fov_y 0.75 → (viewmat, fx, fy, cx, cy),
    the intrinsics the float32 values segsplat_tpu_torch.bench renders with."""
    import numpy as np

    from segsplat_tpu_torch.perf_raster_stages import bench_intrinsics

    return (np.eye(4, dtype=np.float32), *bench_intrinsics(W, H))


# ───────────────────────────────── phases ─────────────────────────────────────

def project_checked(*args, **kw):
    """``project_gaussians(*args, **kw)`` under no_grad, which must launch the
    projection kernel once and give ``project_gaussians_plain``'s bits in all
    five outputs (``torch.equal``); returns the kernel's Projected."""
    import torch

    from segsplat_tpu_torch.ops.rasterize import (Projected, project_gaussians,
                                                  project_gaussians_plain)

    before = project_gaussians.launches
    with torch.no_grad():
        got = project_gaussians(*args, **kw)
        ref = project_gaussians_plain(*args, **kw)
    if project_gaussians.launches != before + 1:
        raise AssertionError(f"the projection launched its kernel "
                             f"{project_gaussians.launches - before} times, not once")
    for name in Projected._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if g.dtype != r.dtype or g.shape != r.shape or not torch.equal(g, r):
            raise AssertionError(f"projection kernel's {name} differs from the plain "
                                 f"version's: {g.dtype} {tuple(g.shape)} against {r.dtype} "
                                 f"{tuple(r.shape)}, "
                                 f"{int((g != r).sum()) if g.shape == r.shape else '?'} differ")
    return got


def blend_inputs_on_card(sc, W, H, cam, m, K, pair_cap=None):
    import torch

    from segsplat_tpu_torch.ops.rasterize import build_blend_inputs

    dev = torch.device("cuda")
    t = {k: torch.as_tensor(sc[k], device=dev) for k in ("xyz", "scales", "quats",
                                                         "opac", "logits")}
    vm, fx, fy, cx, cy = cam
    proj = project_checked(t["xyz"], t["scales"], t["quats"],
                           torch.as_tensor(vm, device=dev), fx, fy, cx, cy, W, H)
    return t, build_blend_inputs(proj, t["logits"], t["opac"], W, H, m, K, pair_cap=pair_cap)


CARD_TESTS = ("tests/test_torch_blend_cuda.py", "tests/test_torch_project_cuda.py",
              "tests/test_torch_lift_cuda.py")
CARD_TESTS_TIMEOUT = 900


def phase_card_tests(root: str):
    """Phase 2: CARD_TESTS in one child process (``--noconftest``:
    tests/conftest.py imports JAX). Raises on a non-zero exit, on any skipped
    case or on no passes; logs the counts of passes, failures and skips."""
    import xml.etree.ElementTree as ET

    report = os.path.join(root, "card_tests.xml")
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                            "no:cacheprovider", "-q", "-rs", f"--junitxml={report}", *CARD_TESTS],
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=CARD_TESTS_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        out, err = (b.decode(errors="replace") if isinstance(b, bytes) else b or ""
                    for b in (e.stdout, e.stderr))
        raise AssertionError(f"the card tests ran past {CARD_TESTS_TIMEOUT} s:"
                             f"\n{out[-6000:]}\n{err[-3000:]}") from e
    if not os.path.exists(report):
        raise AssertionError(f"the card tests exited {r.returncode} with no report:"
                             f"\n{r.stdout[-6000:]}\n{r.stderr[-3000:]}")
    suite = ET.parse(report).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
    counts = dict(passed=n["tests"] - n["failures"] - n["errors"] - n["skipped"],
                  failed=n["failures"], errors=n["errors"], skipped=n["skipped"],
                  seconds=time.perf_counter() - t0, files=list(CARD_TESTS))
    log(f"[small] the card tests: {json.dumps(counts)}")
    if r.returncode != 0 or counts["skipped"] or not counts["passed"]:
        raise AssertionError(f"the card tests exited {r.returncode} with {json.dumps(counts)}:"
                             f"\n{r.stdout[-6000:]}\n{r.stderr[-3000:]}")


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
                                                  project_gaussians_plain, rasterize)

    W, H = FRAME_W, FRAME_H
    cam = bench_camera(W, H)
    vm, fx, fy, cx, cy = cam
    for name in ("headline", "hostile"):
        sc = bench_scene(name)
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
                                   t["logits"], vm_t, fx, fy, cx, cy, W, H, bg=bg,
                                   max_tiles_per_axis=m, max_per_tile=K, pair_cap=cap)
        project = lambda: project_gaussians(t["xyz"], t["scales"], t["quats"], vm_t,
                                            fx, fy, cx, cy, W, H)
        proj = project_checked(t["xyz"], t["scales"], t["quats"], vm_t, fx, fy, cx, cy, W, H)
        binning = lambda: build_blend_inputs(proj, t["logits"], t["opac"], W, H, m, K,
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
        with torch.no_grad():
            iargs = indexed_inputs(proj, t["logits"], t["opac"], W, H, m, K, bg, pair_cap=cap)
            scene["indexed"] = k1_indexed_on_inputs(
                results, iargs, (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K), name)
        del iargs
        results["scenes"][name] = scene
        log(f"[full] {name}: " + json.dumps(scene))
        if name == "headline":
            plain_project = lambda: project_gaussians_plain(t["xyz"], t["scales"], t["quats"],
                                                            vm_t, fx, fy, cx, cy, W, H)
            results["project"] = project_stats(project, plain_project, t["xyz"].shape[0])
            log("[full] headline projection: " + json.dumps(results["project"]))
            results["k2_32"] = k2_on_frame(results, t, bi, bg, cam, W, H, m, K, cap)
            log("[full] headline K2 CH=32: " + json.dumps(results["k2_32"]))
        del t, bi
        torch.cuda.empty_cache()


def host_ms(fn, calls: int = 100) -> float:
    """Median host time of one ``fn()`` call, the card left to run behind."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def project_stats(project, plain, n: int) -> dict:
    """The projection on a frame of ``n`` Gaussians: the kernel's device ms
    (profiler), the whole call's (CUDA events: the kernel with its eager
    matmul and norm) and the plain version's, host ms a call of each, and the
    kernel's bound: PROJECT_BYTES a Gaussian over 3.35 TB/s."""
    import torch

    with torch.no_grad():
        trace = device_trace(lambda v: project(), 20, share_of="project_kernel")
        kernel = trace.get("project_kernel")
        bytes_ = PROJECT_BYTES * n
        return dict(ms=kernel["ms_per_view"] if kernel else "not measured",
                    kernel_launches_per_call=kernel["launches_per_view"] if kernel else None,
                    call_ms=cuda_time_ms(project, reps=20),
                    plain_ms=cuda_time_ms(plain, reps=10),
                    host_ms=host_ms(project), plain_host_ms=host_ms(plain, calls=20),
                    bound_ms=bytes_ / PEAK_HBM_BYTES * 1e3, bound_by="bytes", bytes=bytes_,
                    gaussians=n)


def project_bwd_stats(table, camera) -> dict:
    """The projection's backward kernel at the train step's size, on its
    table and camera: the kernel's device ms (profiler) inside autograd's
    backward of the projection (the kernel, then the eager matmul's and
    norm's backward), that whole backward's ms and the plain version's
    autograd backward (CUDA events), host ms of each, its bound
    (PROJECT_BWD_BYTES a row over 3.35 TB/s), and the gradients of xyz,
    scales and quats against the plain version's. The cotangents are the
    step's: means2d and conics, none for depths."""
    import torch

    from segsplat_tpu_torch.ops import rasterize as R

    K = camera.intrinsics()
    cam = (camera.world_view_transform(), K[0, 0], K[1, 1], K[0, 2], K[1, 2], TRAIN_W, TRAIN_H)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (table.xyz, table.get_scaling(), table.get_rotation())]
    gen = torch.Generator(DEV).manual_seed(3)
    n = leaves[0].shape[0]
    cots = (torch.randn((n, 2), device=DEV, generator=gen),
            torch.randn((n, 3), device=DEV, generator=gen))
    before = R.project_gaussians.backward_launches
    out = R.project_gaussians(*leaves, *cam)
    plain = R.project_gaussians_plain(*leaves, *cam)
    kernel_bwd = lambda: torch.autograd.grad((out.means2d, out.conics), leaves, cots,
                                             retain_graph=True)
    plain_bwd = lambda: torch.autograd.grad((plain.means2d, plain.conics), leaves, cots,
                                            retain_graph=True)
    got, ref = kernel_bwd(), plain_bwd()
    if R.project_gaussians.backward_launches != before + 1:
        raise AssertionError("the projection's backward did not launch its kernel once")
    err = {k: compare_grad(f"projection backward {k}", g, r)
           for k, g, r in zip(("xyz", "scales", "quats"), got, ref)}
    trace = device_trace(lambda v: kernel_bwd(), 20, share_of="project_bwd_kernel")
    kernel = trace.get("project_bwd_kernel")
    bytes_ = PROJECT_BWD_BYTES * n
    return dict(ms=kernel["ms_per_view"] if kernel else "not measured",
                kernel_launches_per_call=kernel["launches_per_view"] if kernel else None,
                call_ms=cuda_time_ms(kernel_bwd, reps=20), plain_ms=cuda_time_ms(plain_bwd, reps=10),
                host_ms=host_ms(kernel_bwd), plain_host_ms=host_ms(plain_bwd, calls=20),
                bound_ms=bytes_ / PEAK_HBM_BYTES * 1e3, bound_by="bytes", bytes=bytes_,
                gaussians=n, max_abs_err=max(err.values()), grad_max_abs_diff=err)


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
    colors = t["logits"].detach().requires_grad_(True)
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

    sc = bench_scene("headline")
    n = sc["xyz"].shape[0]
    op = sc["opac"].astype(np.float64)
    save_gaussian_ply(
        os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"),
        xyz=sc["xyz"], features_dc=np.zeros((n, 1, 3), np.float32),
        features_rest=np.zeros((n, 15, 3), np.float32),
        opacity=np.log(op / (1.0 - op)).astype(np.float32),
        scaling=np.log(sc["scales"]), rotation=sc["quats"])
    sem = os.path.join(root, "gaussian_semantics.npz")
    save_semantics(sem, labels=sc["logits"].argmax(1), logits=sc["logits"],
                   prompts=[f"class_{i}" for i in range(32)])
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(repr(Namespace(source_path=src, model_path=model, images="images",
                               object_path="object_mask", resolution=1,
                               white_background=False, sh_degree=3, eval=False)))
    return model, sem


def view0_blend_inputs(src: str, model: str, iteration: int, sem: str):
    """View 0's blend inputs as ``render_semantic_views`` builds them (m = 6,
    K = 256, no pair cap, bg 0): the scene, its Gaussians and the semantics
    loaded again on the card. Returns (scene, logits [capacity, P] on the card,
    camera, BlendInputs, bg, K, the indexed variant's arguments)."""
    import torch

    from segsplat_tpu_torch.ops.rasterize import build_blend_inputs
    from segsplat_tpu_torch.pipeline.render_semantics import attach_logits_for_table
    from segsplat_tpu_torch.render import _semantic_inputs
    from segsplat_tpu_torch.scene import Scene, to_device_camera

    m, K = 6, 256                       # render_semantic_views' defaults
    scene = Scene(src, model, shuffle=False, load_iteration=iteration, device=DEV)
    table = scene.gaussians
    cam = to_device_camera(scene.get_train_cameras()[0], 1.0, device=DEV)
    logits = torch.as_tensor(attach_logits_for_table(table, sem), device=DEV)
    (xyz, scaling, rotation, opac, payload), bg = _semantic_inputs(table, logits, 0.0)
    Kc = cam.intrinsics()
    proj = project_checked(xyz, scaling, rotation, cam.world_view_transform(), Kc[0, 0],
                           Kc[1, 1], Kc[0, 2], Kc[1, 2], cam.width, cam.height)
    bi = build_blend_inputs(proj, payload, opac, cam.width, cam.height, m, K)
    iargs = indexed_inputs(proj, payload, opac, cam.width, cam.height, m, K, bg)
    return scene, logits, cam, bi, bg, K, iargs


def view0_against_plain(src: str, model: str, iteration: int, sem: str, out_dir: str,
                        inputs=None):
    """View 0 of a render CLI's output held against K1's plain version on
    ``inputs``, ``view0_blend_inputs``' result (loaded here if None). The
    saved fp16 logits must lie within 1e-4 + |ref|·2^-10 (fp16's rounding on
    top of 1e-4), the labels must equal the argmax where the top-2 gap >
    1e-2. Returns (max abs diff, labelled pixels held)."""
    import numpy as np
    import torch

    from segsplat_tpu_torch.ops.blend import blend_tiles_plain

    saved = np.load(os.path.join(out_dir, "00000_logits.npy")).astype(np.float32)
    P = saved.shape[0]
    _, _, cam, bi, bg, K, _ = inputs or view0_blend_inputs(src, model, iteration, sem)
    ref, _ = blend_tiles_plain(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
    ref = ref[:cam.height, :cam.width, :P].permute(2, 0, 1).cpu().numpy()
    if saved.shape != ref.shape or not np.isfinite(saved).all():
        raise AssertionError(f"{out_dir} view 0 logits: shape {saved.shape} against the "
                             f"plain blend's {ref.shape}, finite {np.isfinite(saved).all()}")
    err = float(np.abs(saved - ref).max())
    if not np.all(np.abs(saved - ref) <= 1e-4 + np.abs(ref) * 2.0 ** -10):
        raise AssertionError(f"{out_dir} view 0 logits differ from the plain blend by {err}")
    labels = torch.load(os.path.join(out_dir, "00000_labels.pt"),
                        weights_only=True)["label_indices"].numpy()
    top2 = np.sort(ref, axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 1e-2
    if not np.array_equal(labels[clear], ref.argmax(0)[clear]):
        raise AssertionError(f"{out_dir} view 0 labels differ from the plain blend's argmax")
    return err, int(clear.sum())


def phase_main_path(results, root: str):
    """The semantic render path through its CLI twin."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import render_semantics_logits as cli
    from segsplat_tpu_torch.ops.blend import blend_tiles_bwd
    from segsplat_tpu_torch.ops.rasterize import project_gaussians

    n_views = 4
    model, sem = write_model_dir(root, n_views)
    argv = ["--model_path", model, "--iteration", "1", "--semantics", sem,
            "--skip_test", "--resolution", "1", "--device", "cuda"]
    stdout = sys.stdout         # the CLI's safe_state timestamps stdout lines
    reset_k1()
    blend_tiles_bwd.launches = project_gaussians.launches = 0
    t0 = time.perf_counter()
    try:
        cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdout = stdout
    launches = k1_launches()
    results["launches"]["render_semantics"] = dict(launches, blend_bwd=blend_tiles_bwd.launches,
                                                   project=project_gaussians.launches)
    results["cli_s"] = time.perf_counter() - t0
    # no grad: every view blends through K1's indexed variant, none gathers
    # and none runs K3
    if (launches["blend_fwd_indexed"] < n_views or launches["blend_fwd"] != 0
            or launches["blend_packed"] != 0):
        raise AssertionError(f"main path launched K1 {launches} for {n_views} views")
    if project_gaussians.launches < n_views:
        raise AssertionError(f"main path launched the projection kernel "
                             f"{project_gaussians.launches} times for {n_views} views")

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

    inputs = view0_blend_inputs(os.path.join(root, "scene"), model, 1, sem)
    fp16_err, clear = view0_against_plain(os.path.join(root, "scene"), model, 1, sem, out_dir,
                                          inputs)
    _, _, _, bi, bg, K, iargs = inputs
    with torch.no_grad():
        results["main_indexed"] = k1_indexed_on_inputs(
            results, iargs, (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K),
            "main view 0")
    del inputs, bi, iargs
    log(f"[main] CLI rendered {n_views} views at 1920x1080 in "
        f"{results['cli_s']:.3f} s; K1 launches {launches}, projection launches "
        f"{results['launches']['render_semantics']['project']}; view 0 logits vs "
        f"plain max abs diff {fp16_err:.3g} (fp16 file); labels equal on "
        f"{clear} px with top1-top2 > 1e-2")


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


def reset_k1() -> None:
    """Set the forward blends' launch counters to 0: ``blend_tiles`` (K1 on the
    gathered payload: renders that autograd records or a compile traces),
    ``blend_tiles_indexed`` (its indexed variant: every other render on the
    card) and ``blend_tiles_packed`` (K3, which no program path launches)."""
    from segsplat_tpu_torch.ops import blend as B

    B.blend_tiles.launches = B.blend_tiles_indexed.launches = 0
    B.blend_tiles_packed.launches = 0


def k1_launches() -> dict:
    """The forward blends' launches by kernel since ``reset_k1``:
    ``blend_fwd`` K1 on the gathered payload, ``blend_fwd_indexed`` its
    indexed variant, ``blend_packed`` K3."""
    from segsplat_tpu_torch.ops import blend as B

    return {"blend_fwd": B.blend_tiles.launches,
            "blend_fwd_indexed": B.blend_tiles_indexed.launches,
            "blend_packed": B.blend_tiles_packed.launches}


def indexed_inputs(proj, colors, opac, W, H, m, K, bg, pair_cap=None):
    """K1's indexed variant's arguments (offsets, ids, table, bg, tx_n, ty_n,
    K) as ``rasterize`` builds them where nothing needs a gradient."""
    from segsplat_tpu_torch.ops.blend import make_payload
    from segsplat_tpu_torch.ops.rasterize import bin_pairs

    b = bin_pairs(proj, opac, W, H, m, K, pair_cap=pair_cap)
    table = make_payload(proj.means2d, proj.conics, opac, colors)[b.order]
    return b.offsets, b.rank_sorted, table, bg, b.tx_n, b.ty_n, K


def k1_indexed_on_inputs(results, iargs, fargs, label: str) -> dict:
    """K1's indexed variant (``blend_tiles_indexed``) on ``iargs`` against its
    plain version on the same inputs, and bit for bit against K1 on the same
    frame's gathered payload ``fargs``; both timed with CUDA events, with K1's
    bound (the rows and pair-pixels of the plain version on ``fargs``).
    Returns its stats."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    offsets, ids, table, bg, tx_n, ty_n, K = iargs
    ch = bg.shape[0]
    got = B.blend_tiles_indexed(*iargs)
    err = compare(f"{label} K1 indexed CH={ch}", got, B.blend_tiles_indexed_plain(*iargs))
    gathered = B.blend_tiles(*fargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, gathered)):
        raise AssertionError(f"{label}: K1's indexed variant parts from K1 on the gathered "
                             f"payload")
    results["fwd_err"] = max(results["fwd_err"], err)
    del got, gathered
    _, _, rows, hits, _ = B.blend_tiles_plain_with_work(*fargs)
    stats = dict(ms=cuda_time_ms(lambda: B.blend_tiles_indexed(*iargs), reps=10),
                 gathered_ms=cuda_time_ms(lambda: B.blend_tiles(*fargs), reps=10),
                 plain_ms=cuda_time_ms(lambda: B.blend_tiles_indexed_plain(*iargs), reps=3,
                                       warmup=1),
                 rows_read=rows, pixels_hit=hits, table_rows=int(table.shape[0]),
                 max_abs_err=err, same_bits_as_gathered=True, kernel_width=B.kernel_width(ch))
    stats["bound_ms"], stats["bound_by"], stats["ops"], stats["bytes"] = k1_bound(
        offsets, rows, hits, ch, tx_n * ty_n)
    log(f"[{label}] K1 indexed CH={ch}: " + json.dumps(stats))
    return stats


def blend_node(total):
    """The blend's autograd node (K1's op, ``segsplat_torch::blend_fwd``) in the
    graph of ``total``."""
    seen, stack = set(), [total.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "segsplat_torch_blend_fwd" in type(node).__name__:    # K1's op's autograd
            return node
        stack.extend(f for f, _ in node.next_functions)
    raise AssertionError("the step's graph has no blend node")


def kernels_on_captured(results, cap, label: str, size: str = f"{TRAIN_W}x{TRAIN_H}"):
    """K1 and K2 on a blend node's own inputs and cotangents (captured by a
    prehook), against their plain versions, timed with CUDA events, with their
    bounds. Returns (fwd, bwd) stats."""
    import torch

    offsets, payload, bg, img, alpha = (t.detach() for t in cap["saved"])
    # a loss that does not read alpha gets zeros there from autograd
    g_img, g_alpha = (torch.zeros_like(x) if g is None else g.detach().contiguous()
                      for g, x in zip(cap["grads"], (img, alpha)))
    return kernels_on_inputs(results, (offsets, payload, bg, *cap["dims"]), img, alpha,
                             g_img, g_alpha, label, size)


def kernels_on_inputs(results, fargs, img, alpha, g_img, g_alpha, label: str, size: str):
    """K1 on the blend inputs ``fargs`` and K2 on them with the forward's
    outputs and these cotangents, against their plain versions, timed with
    CUDA events, with their bounds at the real channel count (a width the
    kernel pads up to counts its zero columns as waste, not work). Returns
    (fwd, bwd) stats."""
    from segsplat_tpu_torch.ops import blend as B

    offsets, payload, bg, tx_n, ty_n, K = fargs
    ch = bg.shape[0]
    fwd = k1_on_inputs(results, fargs, label, size)
    bargs = (offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K)
    b_pay, b_bg = B.blend_tiles_bwd(*bargs)
    r_pay, r_bg, b_rows, b_hits = B.blend_tiles_bwd_plain_with_work(*bargs)
    bwd_err = max(compare_grad(f"{label} K2 CH={ch} d_payload", b_pay, r_pay),
                  compare_grad(f"{label} K2 CH={ch} d_bg", b_bg, r_bg))
    results["bwd_err"] = max(results["bwd_err"], bwd_err)
    del b_pay, r_pay
    num_tiles = tx_n * ty_n
    bwd = dict(ms=cuda_time_ms(lambda: B.blend_tiles_bwd(*bargs), reps=10),
               plain_ms=cuda_time_ms(lambda: B.blend_tiles_bwd_plain(*bargs), reps=3,
                                     warmup=1),
               rows_read=b_rows, pixels_hit=b_hits, payload_rows=int(payload.shape[0]),
               max_abs_err=bwd_err, kernel_width=B.kernel_width(ch))
    bwd["bound_ms"], bwd["bound_by"], bwd["ops"], bwd["bytes"] = k2_bound(
        offsets, payload.shape[0], b_rows, b_hits, ch, num_tiles)
    log(f"[{label}] K2 CH={ch} at {size}: " + json.dumps(bwd))
    return fwd, bwd


def k1_on_inputs(results, fargs, label: str, size: str) -> dict:
    """K1 on the blend inputs ``fargs`` against its plain version, timed with
    CUDA events, with its bound at the real channel count. Returns its stats."""
    from segsplat_tpu_torch.ops import blend as B

    offsets, payload, bg, tx_n, ty_n, K = fargs
    ch = bg.shape[0]
    f_got = B.blend_tiles(*fargs)
    f_img, f_alpha, f_rows, f_hits, _ = B.blend_tiles_plain_with_work(*fargs)
    fwd_err = compare(f"{label} K1 CH={ch}", f_got, (f_img, f_alpha))
    results["fwd_err"] = max(results["fwd_err"], fwd_err)
    del f_got, f_img, f_alpha
    fwd = dict(ms=cuda_time_ms(lambda: B.blend_tiles(*fargs), reps=10),
               plain_ms=cuda_time_ms(lambda: B.blend_tiles_plain(*fargs), reps=3, warmup=1),
               rows_read=f_rows, pixels_hit=f_hits, max_abs_err=fwd_err,
               kernel_width=B.kernel_width(ch),
               **warp_row_shares(f"{label} K1 CH={ch}", B.blend_tiles_warp_rows(*fargs)))
    fwd["bound_ms"], fwd["bound_by"], fwd["ops"], fwd["bytes"] = k1_bound(
        offsets, f_rows, f_hits, ch, tx_n * ty_n)
    log(f"[{label}] K1 CH={ch} at {size}: " + json.dumps(fwd))
    return fwd


def capture_blend(total, cap: dict):
    """Have ``total``'s backward record its blend node's residuals, dims and
    incoming cotangents into ``cap``."""
    node = blend_node(total)
    node.register_prehook(lambda g: cap.update(saved=node.saved_tensors, dims=node.dims,
                                               grads=g))


def phase_train_step(results):
    import torch

    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops import rasterize as R
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
    # the projection's backward kernel on the step's table and camera
    results["project_bwd"] = project_bwd_stats(state.table, train_camera(0.0))
    log("[train] projection backward: " + json.dumps(results["project_bwd"]))

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
    proj_before = R.project_gaussians.launches, R.project_gaussians.backward_launches
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
    proj = (R.project_gaussians.launches - proj_before[0],
            R.project_gaussians.backward_launches - proj_before[1])
    if proj != (warm + timed_steps,) * 2:     # the projection's kernels, once each a step
        raise AssertionError(f"{warm + timed_steps} train steps launched the projection's "
                             f"forward and backward kernels {proj} times")
    results["train_step"] = dict(
        median_ms=med, steps=timed_steps, init_table_s=init_s, project_launches=proj,
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

    # a per-tile K that is no multiple of 128 trains on the kernels too
    k_odd, k_iters = 200, 3
    blend_tiles.launches = blend_tiles_bwd.launches = 0
    try:
        odd_state = cli.main(["-s", src, "-m", os.path.join(root, "train_model_k200"),
                              "--iterations", str(k_iters), "--capacity", str(TRAIN_CAP),
                              "--max_per_tile", str(k_odd), "--device", DEV])
        torch.cuda.synchronize()
    finally:
        sys.stdout = stdout
    odd = {"blend_fwd": blend_tiles.launches, "blend_bwd": blend_tiles_bwd.launches}
    if min(odd.values()) < k_iters or odd_state.step != k_iters or not bool(
            torch.isfinite(odd_state.table.xyz).all()):
        raise AssertionError(f"K={k_odd}: {k_iters} iterations launched {odd}, ended at "
                             f"step {odd_state.step}")
    results["train_cli"] = dict(
        seconds=cli_s, launches=launches, last=steps[-1], eval=evals[-1],
        num_gaussians=int(active.sum()), ply=ply,
        odd_k=dict(max_per_tile=k_odd, iterations=k_iters, launches=odd))
    log(f"[train-cli] {TRAIN_ITERS} iterations at {TRAIN_W}x{TRAIN_H} through "
        f"segsplat_tpu_torch.train in {cli_s:.1f} s: launches {launches}; last "
        f"{json.dumps(steps[-1])}; eval {json.dumps(evals[-1])}; PLY reloads with "
        f"{int(active.sum())} active rows; at --max_per_tile {k_odd}, {k_iters} iterations "
        f"launched {odd}")


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
            "logits51", (offsets, packed, torch.zeros(51, device=DEV), tx_n, ty_n, K),
            (offsets, payload, torch.zeros(51, device=DEV), tx_n, ty_n, K))
    del cap, table, leaves, logits
    torch.cuda.empty_cache()


def packed_stats(name, pargs, dargs):
    """K3 on a frame's packed payload ``pargs`` (no program path runs it)
    against its plain version at 1e-4 and against K1 on the K1 payload
    ``dargs`` at ``packed_atol``; timed with its bound."""
    import torch

    from segsplat_tpu_torch.ops import blend as B

    before = B.blend_tiles_packed.launches
    got = B.blend_tiles_packed(*pargs)
    ref_img, ref_alpha, rows, hits, stopped = B.blend_tiles_packed_plain_with_work(*pargs)
    torch.cuda.synchronize()
    if B.blend_tiles_packed.launches != before + 1:
        raise AssertionError(f"{name}: blend_tiles_packed did not launch K3")
    err = compare(f"{name} K3", got, (ref_img, ref_alpha))
    k1_img, k1_alpha, _, _, k1_stopped = B.blend_tiles_plain_with_work(*dargs)
    k1_err = compare(f"{name} K3 vs K1", got, (k1_img, k1_alpha),
                     atol=packed_atol(dargs[1], dargs[2]))
    del got, ref_img, ref_alpha, k1_img, k1_alpha
    offsets, ch, num_tiles = pargs[0], pargs[2].shape[0], pargs[3] * pargs[4]
    stats = dict(max_abs_err=err, vs_k1_max_abs_err=k1_err, ch=ch,
                 rows_read=rows, pixels_hit=hits, tiles_stopped=stopped,
                 k1_tiles_stopped=k1_stopped,
                 ms=cuda_time_ms(lambda: B.blend_tiles_packed(*pargs), reps=10),
                 plain_ms=cuda_time_ms(lambda: B.blend_tiles_packed_plain(*pargs), reps=3,
                                       warmup=1),
                 **warp_row_shares(f"{name} K3", B.blend_tiles_packed_warp_rows(*pargs)))
    stats["bound_ms"], stats["bound_by"], stats["ops"], stats["bytes"] = k1_bound(
        offsets, rows, hits, ch, num_tiles, row_bytes=k3_row_bytes(ch))
    log(f"[packed] {name}: " + json.dumps(stats))
    return stats


def phase_other_blends(results):
    """(b) K3 on the 1080p headline and hostile frames' rows, packed with
    ``pack_payload``; (c) the dense backend on the headline scene against K1."""
    import torch

    from segsplat_tpu_torch.ops.blend import pack_payload
    from segsplat_tpu_torch.ops.rasterize import rasterize

    W, H = FRAME_W, FRAME_H
    cam = bench_camera(W, H)
    vm, fx, fy, cx, cy = cam
    vm_t = torch.as_tensor(vm, device=DEV)
    bg = torch.zeros(32, device=DEV)
    for name in ("headline", "hostile"):
        sc = bench_scene(name)
        m, K, cap = sc["m"], sc["K"], sc["pair_cap"]
        t, bi = blend_inputs_on_card(sc, W, H, cam, m, K, pair_cap=cap)
        raster = lambda backend="cuda": rasterize(
            t["xyz"], t["scales"], t["quats"], t["opac"], t["logits"], vm_t, fx, fy, cx,
            cy, W, H, bg=bg, max_tiles_per_axis=m, max_per_tile=K, pair_cap=cap,
            backend=backend)
        with torch.no_grad():
            results["packed"][name] = packed_stats(
                name, (bi.offsets, pack_payload(bi.sorted_payload[:-K], K), bg, bi.tx_n, bi.ty_n,
                       K), (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K))
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
        del t, bi
        torch.cuda.empty_cache()


# ─────────────────────────── phase 8: feature lifting ───────────────────────────

LIFT_SPLAT_VIEWS = 216      # the reference's view count (LiftConfig.max_views)
LIFT_DDA_VIEWS = 16
LIFT_CLI_VIEWS = 8
LIFT_HIT_AGREE = 0.97       # splat against DDA, share of pixels
LIFT_CARD_AGREE = 0.999     # card against CPU, share of pixels
LIFT_ORACLE_AGREE = 0.995   # DDA against the kernel's numpy transcription
# the record_function ranges of ops/lift.py, ops/lift_splat.py and
# pipeline/lift_features.resize_features
LIFT_STAGES = ("lift.resize", "lift.projection", "lift.binning", "lift.tile_test",
               "lift.first_hit", "lift.accumulation")


def phase_lift_small(results):
    """(a) the DDA and the splat on the small scenes of tests/test_torch_lift*.py."""
    import numpy as np
    import torch

    _tests_on_path()
    from _torch_port import LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy, occupied_voxels
    from oracles import make_test_scene, oracle_first_hit

    from segsplat_tpu_torch.ops import lift as PL
    from segsplat_tpu_torch.ops import lift_splat as PS

    def on(dev, *xs):
        return [torch.as_tensor(np.array(x), device=dev) for x in xs]

    def share(a, b):
        return float((a.cpu() == b.cpu()).float().mean())

    occ, c2w, intr, origin, vs, w, h = make_test_scene(np.random.default_rng(3))
    steps = PL.default_max_steps(w, h, intr[0], intr[1], 0.01, 3.0, vs * 0.5)
    dda = {dev: PL.first_hit_voxels(*on(dev, occ, c2w, intr, origin, np.float32(vs)), 0.01,
                                    3.0, *on(dev, np.float32(vs * 0.5)), w, h, steps)
           for dev in ("cuda", "cpu")}
    oracle = oracle_first_hit(occ, c2w, intr, origin, vs, 0.01, 3.0, vs * 0.5, w, h)
    agree = {"dda_vs_oracle": share(dda["cuda"], torch.as_tensor(oracle)),
             "dda_card_vs_cpu": share(dda["cuda"], dda["cpu"])}

    W, H, C = 64, 48, 32
    grid = lift_occupancy(np.random.default_rng(0))
    centers, ids = occupied_voxels(grid, LIFT_VS, LIFT_ORIGIN)
    num_ids = int(ids.max()) + 1
    k = np.array([70.0, 70.0, W / 2, H / 2], np.float32)
    kw = dict(max_tiles_per_axis=6, max_per_tile=128, tile_chunk=8)
    steps = PL.default_max_steps(W, H, 70.0, 70.0, 0.05, 8.0, LIFT_VS * 0.5)
    worst_sums = 0.0
    for view in range(3):
        feats = np.random.default_rng(view).random((H, W, C)).astype(np.float32)
        hits = {}
        for dev in ("cuda", "cpu"):
            c, i, cw, kk, v, inc, o, org, f = on(dev, centers, ids, lift_camera(view, 3), k,
                                                 np.float32(LIFT_VS),
                                                 np.float32(LIFT_VS * 0.5), grid,
                                                 LIFT_ORIGIN, feats)
            hits[dev] = (PL.first_hit_voxels(o, cw, kk, org, v, 0.05, 8.0, inc, W, H, steps),
                         PS.first_hit_voxels_splat(c, i, cw, kk, v, 0.05, 8.0, inc, W, H,
                                                   **kw))
            if dev == "cuda":
                s, cnt, _ = PS.lift_view_splat(c, i, cw, kk, v, 0.05, 8.0, inc, f, num_ids,
                                               W, H, **kw)
                ref_s, ref_c = PL.scatter_features(f, hits[dev][1], num_ids)
                if not torch.equal(cnt, ref_c):
                    raise AssertionError(f"lift view {view}: fused counts differ from "
                                         f"hits + scatter_features")
                torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=1e-5)
                worst_sums = max(worst_sums, float((s - ref_s).abs().max()))
        agree[f"splat_vs_dda_view{view}"] = share(hits["cuda"][1], hits["cuda"][0])
        agree[f"dda_card_vs_cpu_view{view}"] = share(hits["cuda"][0], hits["cpu"][0])
        agree[f"splat_card_vs_cpu_view{view}"] = share(hits["cuda"][1], hits["cpu"][1])
    torch.cuda.synchronize()
    for key, val in agree.items():
        need = (LIFT_ORACLE_AGREE if "oracle" in key else
                LIFT_CARD_AGREE if "card" in key else LIFT_HIT_AGREE)
        if val < need:
            raise AssertionError(f"lift small scenes: {key} agrees on {val:.4f} < {need}")
    results["lift_small"] = dict(agree=agree, fused_sums_max_abs_diff=worst_sums)
    log(f"[lift-small] pixel agreement {json.dumps({k: round(v, 5) for k, v in agree.items()})}; "
        f"lift_view_splat against hits + scatter_features: counts equal, sums max abs "
        f"diff {worst_sums:.3g}")


RANGE_PREFIXES = ("lift.", "lseg.", "query.", "segment.")   # the port's record_function ranges


def profiled(fn, n_views: int):
    """The profiler's events of ``fn(v)`` for n views, and the device kernels
    among them (the device-side copies of record_function ranges left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v in range(n_views):
            fn(v)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(RANGE_PREFIXES)]
    return events, kernels


def stage_profile(fn, n_views: int, stages=LIFT_STAGES) -> dict:
    """``fn(v)`` for n views under torch.profiler: for each stage (the
    record_function ranges ``stages``), the device time of the kernels
    launched inside its ranges and the host time spent in them, ms per view,
    and the ranges per view; "rest" is the kernel time outside every range.
    The profiler's own cost inflates the host times, not the device times."""
    from torch.autograd import DeviceType

    events, kernels = profiled(fn, n_views)
    total_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    if not kernels:
        return {"device_time": "not measured"}
    out = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in stages:
            d = out.setdefault(e.name.split(".", 1)[1], dict(device_ms=0.0, host_ms=0.0,
                                                              ranges=0))
            d["device_ms"] += (e.device_time_total if hasattr(e, "device_time_total")
                               else e.cuda_time_total) / 1e3 / n_views
            d["host_ms"] += e.cpu_time_total / 1e3 / n_views
            d["ranges"] += 1 / n_views
    attributed = sum(d["device_ms"] for d in out.values())
    if attributed == 0.0:       # kernels ran, but none was tied to a range
        return {"device_time": "not measured", "kernel_ms_per_view": total_us / 1e3 / n_views}
    out["rest"] = dict(device_ms=total_us / 1e3 / n_views - attributed)
    return out


def device_trace(fn, n_views: int, share_of: str = "") -> dict:
    """``fn(v)`` for n views under torch.profiler: kernels launched and their
    device time per view, the device's idle share between the first kernel's
    start and the last one's end, and the five kernels that take most time;
    with ``share_of``, the kernels whose name holds it: launches, ms per view
    and their share of the busy time. The profiler's own host cost widens the
    gaps, so the idle share is an upper bound. Device times are "not
    measured" if the trace holds none."""
    _, kernels = profiled(fn, n_views)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        return {"device_time": "not measured"}
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s = busy + (cur_e - cur_s), s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}                # [count, µs] per kernel name, cut to 90 characters
    for e in kernels:
        entry = by_name.setdefault(e.name[:90], [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    out = dict(kernels_per_view=len(spans) / n_views, busy_ms_per_view=busy / 1e3 / n_views,
               window_ms_per_view=window / 1e3 / n_views, idle_share=1.0 - busy / window,
               top_per_view={k: {"launches": n / n_views, "ms": t / 1e3 / n_views}
                             for k, (n, t) in top})
    if share_of:
        mine = [e.time_range.end - e.time_range.start for e in kernels if share_of in e.name]
        out[share_of] = dict(launches_per_view=len(mine) / n_views,
                             ms_per_view=sum(mine) / 1e3 / n_views,
                             share_of_busy=sum(mine) / busy)
    return out


def write_lift_workdir(root: str, sc: dict) -> dict:
    """(c)'s inputs: the scene's grid as a voxel PLY with its header comments, a
    camera JSON in the {"images", "cameras"} layout at twice the ray grid and
    twice the intrinsics (1752×1168, fx 700: the 0.5 downsample gives the
    876×584 rays and fx 350), and the fp16 feature maps as
    view_NNN.npy; the maps are also returned, in view order."""
    import numpy as np

    from segsplat_tpu_torch.io.ply import write_voxel_grid_ply

    os.makedirs(os.path.join(root, "lseg"))
    ply = os.path.join(root, "grid.ply")
    write_voxel_grid_ply(ply, sc["centers"], np.full((len(sc["centers"]), 3), 127, np.uint8),
                         sc["vs"], sc["origin"], grid_shape=sc["grid_shape"])
    images, maps = {}, []
    for i, fmap in enumerate(sc["feats"]):
        np.save(os.path.join(root, "lseg", f"view_{i:03d}.npy"), fmap)
        maps.append(fmap)
        images[str(i)] = {"name": f"view_{i:03d}.png", "camera_id": "0",
                          "R": sc["c2ws"][i, :3, :3].T.tolist(), "tvec": [0.0, 0.0, 0.0]}
    cams = os.path.join(root, "cameras.json")
    with open(cams, "w") as f:
        json.dump({"images": images, "cameras": {"0": {
            "params": [float(2 * x) for x in sc["intr"][0]], "width": 2 * sc["W"],
            "height": 2 * sc["H"]}}}, f)
    return dict(ply=ply, lseg=os.path.join(root, "lseg"), cams=cams, maps=maps)


def phase_lift(results, root: str):
    """Phase 8: (a) the small scenes, (b) full width in process, (c) through the
    two entry points."""
    import itertools

    import numpy as np
    import torch

    from segsplat_tpu_torch import aggregate_voxel_features_onthefly as lift_cli
    from segsplat_tpu_torch import bench
    from segsplat_tpu_torch import minkowski_voxel_grid_from_ply_advanced as grid_cli
    from segsplat_tpu_torch.io.artifacts import load_voxel_features
    from segsplat_tpu_torch.io.ply import read_voxel_grid_ply
    from segsplat_tpu_torch.ops import lift as PL
    from segsplat_tpu_torch.ops import lift_splat as PS
    from segsplat_tpu_torch.pipeline.lift_features import (LiftConfig, lift_grid,
                                                           resize_features)

    phase_lift_small(results)
    t0 = time.perf_counter()
    sc = bench.officescene_lift_scene(n_views=LIFT_CLI_VIEWS)
    work = write_lift_workdir(os.path.join(root, "lift"), sc)
    log(f"[lift] scene and work dir written in {time.perf_counter() - t0:.1f} s")

    dev = "cuda"
    cfg = LiftConfig()
    W, H, C = sc["W"], sc["H"], sc["C"]
    centers, _, vs, origin, shape = read_voxel_grid_ply(work["ply"])
    _, occ, occ_origin, snap, ids = lift_grid(centers, vs, origin, shape, dev)
    num_ids = len(centers) + 1
    f32 = dict(dtype=torch.float32, device=dev)
    feats = [torch.as_tensor(m, device=dev) for m in work["maps"]]
    c2ws = [torch.as_tensor(c, **f32) for c in sc["c2ws"]]
    intr = [torch.as_tensor(k, **f32) for k in sc["intr"]]
    vs_t = torch.tensor(vs, **f32)
    inc = vs * cfg.ray_increment_factor
    inc_t, org_t = torch.tensor(inc, **f32), torch.as_tensor(occ_origin, **f32)
    dmin, dmax = cfg.depth_min, cfg.depth_max
    fx, fy, cx, cy = (float(x) for x in sc["intr"][0])
    steps = PL.default_max_steps(W, H, fx, fy, dmin, dmax, inc, cx=cx, cy=cy)
    skw = dict(max_tiles_per_axis=cfg.splat_max_tiles_per_axis,
               max_per_tile=cfg.splat_max_per_tile, tile_chunk=PS.TILE_CHUNK)
    n = len(feats)
    num_tiles = -(-W // 16) * -(-H // 16)

    def splat_view(v, tile_chunk=PS.TILE_CHUNK):
        fmap = resize_features(feats[v % n], H, W).permute(1, 2, 0)
        return PS.lift_view_splat(snap, ids, c2ws[v % n], intr[v % n], vs_t, dmin, dmax,
                                  inc_t, fmap, num_ids, W, H, **dict(skw, tile_chunk=tile_chunk))

    def dda_view(v):
        fmap = resize_features(feats[v % n], H, W).permute(1, 2, 0)
        hits = PL.first_hit_voxels(occ, c2ws[v % n], intr[v % n], org_t, vs_t, dmin, dmax,
                                   inc_t, W, H, steps)
        return PL.scatter_features(fmap, hits, num_ids)

    def sweep(view_fn, n_views):
        sums = torch.zeros((num_ids, C), **f32)
        counts = torch.zeros((num_ids,), dtype=torch.int32, device=dev)
        of_max = torch.zeros((), dtype=torch.int64, device=dev)
        of_sum = torch.zeros((), dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for v in range(n_views):
            out = view_fn(v)
            sums += out[0]
            counts += out[1]
            if len(out) == 3:
                of_max, of_sum = torch.maximum(of_max, out[2]), of_sum + out[2]
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        return dict(sums=sums, counts=counts, seconds=s, views_per_sec=n_views / s,
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    overflow_max=int(of_max), overflow_sum=int(of_sum))

    def cycle(fn):
        """fn(view) as a call without arguments that visits the views in turn."""
        it = itertools.count()
        return lambda: fn(next(it) % n)

    splat_view(0)                                  # first calls: allocator, cuBLAS
    dda_view(0)
    out = {}
    for method, view_fn, n_views in (("splat", splat_view, LIFT_SPLAT_VIEWS),
                                     ("dda", dda_view, LIFT_DDA_VIEWS)):
        r = sweep(view_fn, n_views)
        out[method] = {k: r[k] for k in ("seconds", "views_per_sec", "peak_gib",
                                          "overflow_max", "overflow_sum")}
        out[method]["views"] = n_views

    # the splat's tile chunk: 64 (the JAX default, sized for TPU memory), 512,
    # and every tile of the view in one chunk; 3 passes over the 8 views each,
    # counts equal to the default's, sums beside them
    ref = sweep(splat_view, n)
    chunk_sweep = {}
    for tc in sorted({min(c, num_tiles) for c in (64, 512, num_tiles,
                                                  PS.TILE_CHUNK)}):
        fn = lambda v, tc=tc: splat_view(v, tc)
        r = sweep(fn, 3 * n)
        once = sweep(fn, n)
        if not torch.equal(once["counts"], ref["counts"]):
            raise AssertionError(f"tile_chunk {tc}: counts differ from tile_chunk "
                                 f"{PS.TILE_CHUNK}'s")
        tr = device_trace(fn, 1)
        chunk_sweep[tc] = dict(views_per_sec=r["views_per_sec"], peak_gib=r["peak_gib"],
                               sums_max_abs_diff=float((once["sums"] - ref["sums"]).abs().max()),
                               **{k: tr[k] for k in ("kernels_per_view", "busy_ms_per_view",
                                                     "window_ms_per_view", "idle_share")
                                  if k in tr})
    out["tile_chunk_sweep"] = chunk_sweep
    del ref

    # per-view medians of whole calls, CUDA events around each call, over the 8
    # views in turn; on a host-bound path they hold the host's issue time too
    half = vs_t * 0.5
    w2cs = []
    for c2w in c2ws:
        w2c = torch.eye(4, **f32)
        w2c[:3, :3] = c2w[:3, :3].T
        w2c[:3, 3] = -(c2w[:3, :3].T @ c2w[:3, 3])
        w2cs.append(w2c)
    cand = lambda v: PS._splat_candidates(snap, ids, c2ws[v], intr[v], vs_t, dmax, W, H,
                                          skw["max_tiles_per_axis"], skw["max_per_tile"],
                                          None)
    first_splat = lambda v: PS.first_hit_voxels_splat(snap, ids, c2ws[v], intr[v], vs_t, dmin,
                                                      dmax, inc_t, W, H, dual_bin=True, **skw)
    first_dda = lambda v: PL.first_hit_voxels(occ, c2ws[v], intr[v], org_t, vs_t, dmin, dmax,
                                              inc_t, W, H, steps)
    fmap0 = resize_features(feats[0], H, W).permute(1, 2, 0)
    hits0 = first_dda(0)
    reps = 2 * n
    ms = dict(
        resize=cuda_time_ms(cycle(lambda v: resize_features(feats[v], H, W)), reps),
        projection=cuda_time_ms(cycle(lambda v: PS._project_voxels(
            snap, half, w2cs[v], intr[v], W, H, dmax)), reps),
        candidates=cuda_time_ms(cycle(cand), reps),
        splat_first_hit=cuda_time_ms(cycle(first_splat), reps),
        splat_lift=cuda_time_ms(cycle(lambda v: PS.lift_view_splat(
            snap, ids, c2ws[v], intr[v], vs_t, dmin, dmax, inc_t, fmap0, num_ids, W, H,
            **skw)), reps),
        dda_first_hit=cuda_time_ms(cycle(first_dda), n),
        dda_accumulation=cuda_time_ms(lambda: PL.scatter_features(fmap0, hits0, num_ids),
                                      reps))
    out["call_ms"] = ms

    # each stage's device time (kernels inside its record_function ranges) and
    # host time, per view over the 8 views; and one traced view of each lift
    out["stage_profile"] = {m: stage_profile(fn, n) for m, fn in (("splat", splat_view),
                                                                   ("dda", dda_view))}
    out["trace"] = {m: device_trace(fn, 1) for m, fn in (("splat", splat_view),
                                                          ("dda", dda_view))}

    # splat against DDA at full width, on two views
    agree = []
    for v in (0, n - 1):
        agree.append(float((first_splat(v) == first_dda(v)).float().mean()))
    if min(agree) < LIFT_HIT_AGREE:
        raise AssertionError(f"full-width splat and DDA hit images agree on {agree}")
    out["splat_vs_dda_agree"] = agree

    # the same bits from two sweeps of the 8 views
    a, b = sweep(splat_view, n), sweep(splat_view, n)
    if not (torch.equal(a["sums"], b["sums"]) and torch.equal(a["counts"], b["counts"])):
        raise AssertionError("two splat sweeps of the same 8 views gave other bits")
    out["bit_identical_rerun"] = True
    nonzero = int((a["counts"][1:] > 0).sum())

    # (c) the lift CLI on the work dir: the same counts as the sweep above
    out_dir = os.path.join(root, "lift", "out")
    t = time.perf_counter()
    cli = lift_cli.main(["--voxel_ply", work["ply"], "--lseg_dir", work["lseg"],
                         "--camera_params", work["cams"], "--out_dir", out_dir,
                         "--device", dev])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    if not torch.equal(cli["counts"], a["counts"]):
        raise AssertionError("the lift CLI's counts differ from the in-process sweep's")
    art = load_voxel_features(cli["artifact"])
    if art["pos"].shape[0] != nonzero or art["feat"].shape != (nonzero, C) or \
            not np.isfinite(art["feat"]).all():
        raise AssertionError(f"the lift artifact holds {art['feat'].shape}, not "
                             f"({nonzero}, {C}) finite features")
    hit_ply = os.path.join(out_dir, "ALL_nonzero_voxel_features_hitcounts.ply")
    if not os.path.exists(hit_ply):
        raise AssertionError(f"no hit-count PLY {hit_ply}")
    sums_diff = float((cli["sums"] - a["sums"]).abs().max())
    out["cli"] = dict(views=LIFT_CLI_VIEWS, views_per_sec=cli["views_per_sec"],
                      wall_s=cli_s, voxels_hit=nonzero, overflow=cli["overflow"],
                      sums_max_abs_diff_vs_sweep=sums_diff)

    # the grid CLI on phase 6's trained point_cloud.ply, at 0.04 m; the PLY has
    # no normals, and its points are spread, so the normal filter is off and the
    # density ball is 0.1 m
    t = time.perf_counter()
    grid_ply = grid_cli.main(["--ply", results["train_cli"]["ply"], "--output_dir",
                              os.path.join(root, "lift", "grid"), "--cell_size", "0.04",
                              "--opacity_threshold", "0.5", "--normal_consistency", "1.0",
                              "--density_eps", "0.1", "--density_min_neighbors", "5"])
    grid_s = time.perf_counter() - t
    gc_, _, gvs, _, gshape = read_voxel_grid_ply(grid_ply)
    if gvs != 0.04 or len(gc_) < 1000:
        raise AssertionError(f"the grid CLI wrote {len(gc_)} voxels at {gvs}")
    out["grid_cli"] = dict(seconds=grid_s, voxels=len(gc_), grid_shape=gshape)
    out["voxels"] = len(centers)
    results["lift"] = out
    for method in ("splat", "dda"):
        r = out[method]
        log(f"[lift] {method}: {r['views']} views at {W}x{H}, {C} channels, {len(centers)} "
            f"voxels: {r['views_per_sec']:.2f} views/s ({r['seconds']:.2f} s), peak "
            f"{r['peak_gib']:.2f} GiB, overflow max {r['overflow_max']}/view, sum "
            f"{r['overflow_sum']}")
    log(f"[lift] per-view medians of whole calls, CUDA events (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    log(f"[lift] per-stage device and host ms per view (profiler ranges): "
        f"{json.dumps(out['stage_profile'])}")
    log(f"[lift] splat tile_chunk sweep ({num_tiles} tiles a view; default "
        f"{PS.TILE_CHUNK}): {json.dumps(chunk_sweep)}")
    log(f"[lift] one traced view: {json.dumps(out['trace'])}")
    log(f"[lift] splat vs DDA hit images agree on {agree}; a second sweep of the 8 views "
        f"gives the same bits in sums and counts")
    log(f"[lift] CLI: {LIFT_CLI_VIEWS} views in {cli_s:.2f} s wall, {cli['views_per_sec']:.2f} "
        f"views/s, {nonzero} voxels hit, counts equal to the sweep's (sums max abs diff "
        f"{sums_diff:.3g}); grid CLI: {len(gc_)} voxels {gshape} in {grid_s:.2f} s")


# ──────── phase 9: the query, the pipeline, the CLIP text tower and LSeg ────────

QUERY_VOXELS = 109_000          # the officescene table at 0.04 m (PERF.md §4)
QUERY_CHANNELS = 512
QUERY_VS = 0.04
PIPELINE_PROMPTS = ("wall", "floor", "chair", "table", "monitor")   # run_pipeline.py's example
CLIP_PROMPTS = 32
NN_SUBSET = 20_000              # Gaussians held against the CPU's 1-NN
LSEG_IMAGE = (360, 480)         # short side 360 (extract_lseg_features.py), padded to 384×480
LSEG_SMALL_IMAGE = (128, 160)   # full width, card against the CPU
LSEG_FULL: dict = {}            # LSegNet's defaults: ViT-L/16 + DPT, the published widths
CLIP_FULL: dict = {}            # ClipTextEncoder's defaults: CLIP ViT-B/32's text tower
SMALL_CLIP = dict(width=64, layers=2, heads=2, embed_dim=32, vocab_size=50, context_length=12)
SMALL_LSEG = dict(patch=8, width=64, depth=4, heads=2, taps=(0, 1, 2, 3), fusion_features=16,
                  reassemble_dims=(16, 24, 32, 32), out_dim=8, image_size=32)
MODEL_REL = 1e-4                # card against CPU, max abs diff / max|CPU|: small models, text tower
LSEG_FULL_REL = 2e-5            # the same for LSeg at full width (24 blocks, the DPT head):
                                # ~9x the fp32 reading, below the TF32 control's (PERF.md §6)
BF16_COS_MIN = 0.999           # LSeg bf16 against its fp32, least per-pixel cosine
LOGIT_RTOL, LABEL_GAP = 1e-5, 1e-3   # logits at rtol 1e-5, atol 1e-5·scale; labels beyond the gap
LOGIT_SCALE = 1.0 / 0.07
LSEG_STAGES = ("lseg.vit", "lseg.dpt")
QUERY_STAGES = ("query.load", "query.project", "query.fetch", "query.gather", "query.npz",
                "query.ply")
PIPELINE_GRID_ARGS = ("--density_eps", "0.1", "--density_min_neighbors", "5")  # as phase 8c


def clip_prompts(n: int):
    words = ("wall", "floor", "chair", "table", "monitor", "lamp", "door", "window", "sofa",
             "shelf", "plant", "keyboard", "mug", "book", "ceiling", "rug")
    return [f"a photo of a {words[i % len(words)]}" + (" on the left" if i >= len(words) else "")
            for i in range(n)]


def close(name: str, got, ref, rel: float) -> float:
    """Max abs diff of two tensors; raises beyond rel·max|ref| or on a non-finite value."""
    import torch

    got, ref = got.float().cpu(), ref.float().cpu()
    err = float((got - ref).abs().max())
    if got.shape != ref.shape or not torch.isfinite(got).all() or \
            err > rel * float(ref.abs().max()):
        raise AssertionError(f"{name}: card differs from CPU by {err:.3g} (shape {tuple(got.shape)} "
                             f"vs {tuple(ref.shape)}, allowed {rel}·max|ref|)")
    return err


def check_logits(name: str, logits, labels, ref_logits, ref_labels) -> float:
    """Logits at rtol 1e-5 and atol 1e-5·scale, labels equal where the top-2
    gap of the reference exceeds 1e-3. Returns the max abs diff."""
    import numpy as np

    logits, ref_logits = np.asarray(logits), np.asarray(ref_logits)
    diff = np.abs(logits - ref_logits)
    if not np.isfinite(logits).all() or (
            diff > LOGIT_RTOL * LOGIT_SCALE + LOGIT_RTOL * np.abs(ref_logits)).any():
        raise AssertionError(f"{name}: logits differ by {diff.max():.3g}")
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LABEL_GAP
    if not np.array_equal(np.asarray(labels)[clear], np.asarray(ref_labels)[clear]):
        raise AssertionError(f"{name}: labels differ beyond the {LABEL_GAP} top-2 gap")
    return float(diff.max())


def phase_query_small(results):
    """(a) the query's pieces and the two models, narrow, card against CPU."""
    import numpy as np
    import torch

    _tests_on_path()
    from _torch_port import nn_index_mismatch, query_scene

    from segsplat_tpu_torch.models.clip_text import TextTower, project_features_to_labels
    from segsplat_tpu_torch.models.lseg import LSegModel
    from segsplat_tpu_torch.ops.knn import nearest_neighbor_index
    from segsplat_tpu_torch.pipeline.query import hash_prompt_embeddings

    out = {}
    sc = query_scene(seed=1, n_vox=600, n_gauss=9000)
    cpu = nearest_neighbor_index(torch.from_numpy(sc["mu"]), torch.from_numpy(sc["pos"]))
    card = nearest_neighbor_index(torch.as_tensor(sc["mu"], device=DEV),
                                  torch.as_tensor(sc["pos"], device=DEV))
    out["nn_index_differ"], out["nn_max_gap"] = nn_index_mismatch(
        sc["mu"], sc["pos"], card.cpu().numpy(), cpu.numpy())
    feats = np.random.default_rng(2).standard_normal((4000, 32)).astype(np.float32)
    text = hash_prompt_embeddings(list(PIPELINE_PROMPTS), 32)
    ref = project_features_to_labels(torch.from_numpy(feats), torch.from_numpy(text),
                                     LOGIT_SCALE).numpy()
    got = project_features_to_labels(torch.as_tensor(feats, device=DEV),
                                     torch.as_tensor(text, device=DEV), LOGIT_SCALE).cpu().numpy()
    out["projection_err"] = check_logits("small projection", got, got.argmax(1), ref,
                                         ref.argmax(1))
    tokens = np.zeros((3, SMALL_CLIP["context_length"]), np.int64)
    tokens[0, :5] = [48, 3, 7, 12, 49]
    tokens[1, :4] = [48, 30, 2, 49]
    tokens[2] = [48] + list(range(1, 11)) + [49]
    cpu_t = TextTower(config=SMALL_CLIP, device="cpu")
    card_t = TextTower(cpu_t.model.state_dict(), config=SMALL_CLIP, device=DEV)
    out["clip_err"] = close("small text tower", card_t.encode(tokens), cpu_t.encode(tokens),
                            MODEL_REL)
    cpu_l = LSegModel(device="cpu", **SMALL_LSEG)
    card_l = LSegModel(cpu_l.net.state_dict(), device=DEV, **SMALL_LSEG)
    img = torch.from_numpy(np.random.default_rng(4).random((2, 3, 48, 64)).astype(np.float32))
    out["lseg_err"] = close("small LSeg", card_l.features(img), cpu_l.features(img), MODEL_REL)
    results["query_small"] = out
    log(f"[query] small, card vs CPU: 1-NN {out['nn_index_differ']} of 9000 indices differ, "
        f"each a near-tie (largest distance gap {out['nn_max_gap']:.3g}); projection "
        f"{out['projection_err']:.3g}; text tower "
        f"{out['clip_err']:.3g}; LSeg {out['lseg_err']:.3g} (max abs diffs)")


def phase_query_models(results):
    """(b) the CLIP text tower and LSeg at their published widths, seeded weights."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from segsplat_tpu_torch.models.clip_text import TextTower
    from segsplat_tpu_torch.models.lseg import LSegModel
    from segsplat_tpu_torch.models.tokenizer import HashTokenizer

    out = {}
    t0 = time.perf_counter()
    cpu_t = TextTower(config=CLIP_FULL, device="cpu")
    card_t = TextTower(cpu_t.model.state_dict(), config=CLIP_FULL, device=DEV)
    out["clip_build_s"] = time.perf_counter() - t0
    tokens = HashTokenizer()(clip_prompts(CLIP_PROMPTS))
    emb = card_t.encode(tokens)
    width = card_t.model.ln_final.normalized_shape[0]
    layers = len(card_t.model.transformer.resblocks)
    P, T = tokens.shape
    if tuple(emb.shape) != (CLIP_PROMPTS, card_t.model.text_projection.shape[1]):
        raise AssertionError(f"text tower gave {tuple(emb.shape)}")
    out["clip_err"] = close("text tower", emb, cpu_t.encode(tokens), MODEL_REL)
    out["clip_ms"] = cuda_time_ms(lambda: card_t.encode(tokens), reps=10)
    out["clip_trace"] = device_trace(lambda v: card_t.encode(tokens), 1)
    # per token and layer: q, k, v, out and the 4× MLP (24·W²) and the attention (4·T·W)
    out["clip_gflop"] = P * T * layers * (24 * width ** 2 + 4 * T * width) / 1e9
    out["clip_shape"] = list(emb.shape)
    del cpu_t, card_t

    t0 = time.perf_counter()
    cpu_l = LSegModel(device="cpu", **LSEG_FULL)
    sd = cpu_l.net.state_dict()
    nets = {"float32": LSegModel(sd, device=DEV, **LSEG_FULL),
            "bfloat16": LSegModel(sd, device=DEV, compute_dtype=torch.bfloat16, **LSEG_FULL)}
    out["lseg_build_s"] = time.perf_counter() - t0
    h, w = LSEG_IMAGE
    rng = np.random.default_rng(8)
    img = np.zeros((1, 3, -(-h // 32) * 32, -(-w // 32) * 32), np.float32)
    img[:, :, :h, :w] = rng.random((1, 3, h, w))
    x = torch.as_tensor(img, device=DEV)
    feats = {}
    for name, m in nets.items():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feats[name] = m.features(x)[:, :, :h, :w]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[f"lseg_{name}"] = dict(
            ms=cuda_time_ms(lambda: m.features(x), reps=5), peak_gib=peak / 2 ** 30,
            above_resident_gib=(peak - resident) / 2 ** 30,
            stages=stage_profile(lambda v: m.features(x), 1, stages=LSEG_STAGES),
            trace=device_trace(lambda v: m.features(x), 1))
    if tuple(feats["float32"].shape) != (1, nets["float32"].net.scratch.head1.out_channels,
                                         h, w):
        raise AssertionError(f"LSeg gave {tuple(feats['float32'].shape)}")
    cos = F.cosine_similarity(feats["bfloat16"], feats["float32"], dim=1)
    out["bf16_cos_min"], out["bf16_cos_mean"] = float(cos.min()), float(cos.mean())
    if not out["bf16_cos_min"] >= BF16_COS_MIN:
        raise AssertionError(f"LSeg bf16 vs fp32: least per-pixel cosine {out['bf16_cos_min']}")
    sh, sw = LSEG_SMALL_IMAGE
    small = torch.from_numpy(rng.random((1, 3, sh, sw)).astype(np.float32))
    t0 = time.perf_counter()
    ref = cpu_l.features(small)
    out["lseg_cpu_s"] = time.perf_counter() - t0
    out["lseg_card_err"] = close("LSeg full width", nets["float32"].features(small), ref,
                                 LSEG_FULL_REL)
    out["lseg_card_rel"] = out["lseg_card_err"] / float(ref.abs().max())
    # the control: the same image with TF32 allowed, the fault the limit is to catch
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        got_tf32 = nets["float32"].features(small).float().cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["lseg_tf32_rel"] = float((got_tf32 - ref).abs().max()) / float(ref.abs().max())
    if not out["lseg_tf32_rel"] > LSEG_FULL_REL:
        raise AssertionError(f"LSeg with TF32 allowed reads {out['lseg_tf32_rel']:.3g} of "
                             f"max|CPU|, inside the {LSEG_FULL_REL} limit meant to catch it")
    results["query_models"] = out
    del cpu_l, nets, feats
    torch.cuda.empty_cache()
    log(f"[query] text tower (width {width}, {layers} layers, context {T}): {P} prompts → "
        f"{out['clip_shape']} in {out['clip_ms']:.3f} ms ({out['clip_gflop']:.1f} GFLOP), "
        f"vs CPU {out['clip_err']:.3g}, trace {json.dumps(out['clip_trace'])}; LSeg at {h}x{w} (padded {img.shape[2]}x{img.shape[3]}): "
        f"fp32 {json.dumps(out['lseg_float32'])}, bf16 {json.dumps(out['lseg_bfloat16'])}, "
        f"bf16 vs fp32 cosine min {out['bf16_cos_min']:.6f} mean {out['bf16_cos_mean']:.6f}; "
        f"fp32 vs CPU at {sh}x{sw}: {out['lseg_card_err']:.3g} "
        f"({out['lseg_card_rel']:.3g} of max|CPU|; limit {LSEG_FULL_REL}; with TF32 "
        f"allowed {out['lseg_tf32_rel']:.3g})")


def query_table(mu, seed: int = 9):
    """QUERY_VOXELS distinct voxel centres at QUERY_VS drawn from the grid over
    the Gaussians' bounding box, with seeded fp16 features and their coords."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo = mu.min(0)
    dims = np.maximum(np.ceil((mu.max(0) - lo) / QUERY_VS).astype(np.int64), 1)
    cells = rng.choice(int(np.prod(dims)), size=QUERY_VOXELS, replace=False)
    ii = np.stack(np.unravel_index(cells, tuple(dims)), axis=1)
    pos = (lo + (ii + 0.5) * QUERY_VS).astype(np.float32)
    feat = rng.standard_normal((QUERY_VOXELS, QUERY_CHANNELS)).astype(np.float16)
    return pos, feat, ii[:, ::-1].astype(np.int64)


def phase_query_map(results, root: str):
    """(b) build_map on phase 6's trained PLY against a 109 000-voxel table,
    and the query with 5 and 32 prompts."""
    import numpy as np
    import torch

    _tests_on_path()
    from _torch_port import nn_index_mismatch

    from segsplat_tpu_torch.io.artifacts import save_voxel_features
    from segsplat_tpu_torch.ops.knn import nearest_neighbor_index
    from segsplat_tpu_torch.pipeline.query import (build_map, extract_gaussian_centers,
                                                   hash_prompt_embeddings, label_voxels,
                                                   query)

    work = os.path.join(root, "query")
    os.makedirs(work)
    mu_path = os.path.join(work, "gaussian_mu.npy")
    mu = extract_gaussian_centers(results["train_cli"]["ply"], mu_path)
    pos, feat, coords = query_table(mu)
    vox = os.path.join(work, f"ALL_nonzero_voxel_features_{QUERY_VOXELS}vox.pt")
    save_voxel_features(vox, pos, feat, coords)
    g2v = os.path.join(work, "gauss2voxel.npy")
    out = {"gaussians": len(mu), "voxels": QUERY_VOXELS, "channels": QUERY_CHANNELS}

    build_map(vox, mu_path, g2v, device=DEV)        # first call: cuBLAS and allocator
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = build_map(vox, mu_path, g2v, device=DEV)
    out["build_map_s"] = time.perf_counter() - t0
    out["build_map_above_resident_gib"] = (torch.cuda.max_memory_allocated()
                                           - resident) / 2 ** 30
    q, r = torch.as_tensor(mu, device=DEV), torch.as_tensor(pos, device=DEV)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["nn_ms"] = cuda_time_ms(lambda: nearest_neighbor_index(q, r), reps=3)
    out["nn_above_resident_gib"] = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    out["nn_trace"] = device_trace(lambda v: nearest_neighbor_index(q, r), 1)
    # the [M, V] distances written once and read once, in fp32
    out["nn_distance_gb"] = 2 * 4 * len(mu) * QUERY_VOXELS / 1e9
    sub = np.random.default_rng(10).choice(len(mu), size=min(NN_SUBSET, len(mu)), replace=False)
    t0 = time.perf_counter()
    cpu_idx = nearest_neighbor_index(torch.from_numpy(mu[sub]), torch.from_numpy(pos)).numpy()
    out["nn_cpu_subset_s"] = time.perf_counter() - t0
    differ, out["nn_max_gap"] = nn_index_mismatch(mu[sub], pos, idx[sub], cpu_idx)
    out["nn_subset"], out["nn_equal_share"] = len(sub), 1.0 - differ / len(sub)
    del q, r

    g2v_np = np.load(g2v)
    out["query"] = {}
    for prompts in (list(PIPELINE_PROMPTS), clip_prompts(CLIP_PROMPTS)):
        P = len(prompts)
        sem = os.path.join(work, f"gaussian_semantics_{P}.npz")

        def run(v=0):
            return query(vox, g2v, mu_path, prompts, sem, device=DEV)
        t0 = time.perf_counter()
        got = run()
        wall = time.perf_counter() - t0
        # one more call under the profiler: per query() range, the device ms
        # of its kernels and copies and the host ms spent in it
        stages = stage_profile(run, 1, stages=QUERY_STAGES)
        if not (np.array_equal(got["labels"], got["voxel_labels"][g2v_np])
                and got["labels"].min() >= 0 and got["labels"].max() < P
                and got["logits"].shape == (len(mu), P)):
            raise AssertionError(f"query with {P} prompts: labels or logits off")
        rows = np.random.default_rng(11).choice(len(mu), size=NN_SUBSET, replace=False)
        ref = label_voxels(torch.from_numpy(feat[g2v_np[rows]].astype(np.float32)),
                           torch.from_numpy(hash_prompt_embeddings(prompts, QUERY_CHANNELS)),
                           LOGIT_SCALE)
        err = check_logits(f"query with {P} prompts", got["logits"][rows],
                           got["labels"][rows], ref[0].numpy(), ref[1].numpy())
        # the projection reads the table twice (norm, product) and writes logits and labels
        bytes_ = 2 * 4 * QUERY_VOXELS * QUERY_CHANNELS + QUERY_VOXELS * (4 * P + 8)
        flops = QUERY_VOXELS * QUERY_CHANNELS * (2 * P + 3)
        out["query"][P] = dict(
            wall_s=wall, stages=stages, logits_err_vs_cpu=err,
            projection_bound_ms=max(bytes_ / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS) * 1e3,
            label_histogram=np.bincount(got["labels"], minlength=P).tolist()[:8])
    results["query_map"] = out
    torch.cuda.empty_cache()
    log(f"[query] build_map: {len(mu)} Gaussians x {QUERY_VOXELS} voxels in "
        f"{out['build_map_s'] * 1e3:.1f} ms wall (nearest_neighbor_index {out['nn_ms']:.3f} ms, "
        f"{out['nn_above_resident_gib']:.2f} GiB above the resident; {out['nn_distance_gb']:.0f} "
        f"GB of distances; trace {json.dumps(out['nn_trace'])}), "
        f"{out['nn_equal_share'] * 100:.3f} % of {len(sub)} indices equal the CPU's, the rest "
        f"near-ties (largest distance gap {out['nn_max_gap']:.3g})")
    for P, q in out["query"].items():
        log(f"[query] query with {P} prompts: " + json.dumps(q))


def phase_pipeline(results, root: str):
    """(c) the LSeg twin CLI on phase 6's views, the pipeline's refusal of its
    random-weights maps, and the pipeline twin end to end on seeded maps."""
    import numpy as np
    import torch
    from PIL import Image

    _tests_on_path()
    from _torch_port import blender_to_camera_json, write_seeded_maps

    from segsplat_tpu_torch import extract_lseg_features as lseg_cli
    from segsplat_tpu_torch import run_pipeline
    from segsplat_tpu_torch.io.artifacts import load_label_map
    from segsplat_tpu_torch.io.provenance import RANDOM, read_weights_source

    src, model = os.path.join(root, "train_scene"), os.path.join(root, "train_model")
    it = os.path.basename(os.path.dirname(results["train_cli"]["ply"])).split("_")[1]
    work = os.path.join(root, "pipeline")
    W, H = Image.open(os.path.join(src, "r_0.png")).size
    scale = 360 / min(W, H)             # the twin's --short_side
    h, w = round(H * scale), round(W * scale)
    out = {}

    # 1. the LSeg twin at full width, random weights, bf16
    lseg_random = os.path.join(work, "lseg_random")
    t0 = time.perf_counter()
    written = lseg_cli.main(["--images", src, "--out_dir", lseg_random, "--device", DEV])
    torch.cuda.synchronize()
    out["lseg_cli_s"] = time.perf_counter() - t0
    for path in written:
        f = np.load(path)
        if f.dtype != np.float16 or f.shape[1:] != (h, w) or not np.isfinite(f).all():
            raise AssertionError(f"{path}: {f.dtype} {f.shape}, not finite fp16 [C, {h}, {w}]")
    out["lseg_cli_files"], out["lseg_map_shape"] = len(written), list(f.shape)
    if read_weights_source(lseg_random) != RANDOM:
        raise AssertionError("the LSeg twin did not stamp its random weights")

    def pipeline(lseg_dir, cams, run_work):
        stdout = sys.stdout             # the render CLI's safe_state timestamps stdout
        try:
            return run_pipeline.main(
                ["-s", src, "-m", model, "--iteration", it, "--lseg_dir", lseg_dir,
                 "--camera_params", cams, "--prompt", *PIPELINE_PROMPTS, *PIPELINE_GRID_ARGS,
                 "--work_dir", run_work, "--render_backend", "cuda", "--device", DEV])
        finally:
            sys.stdout = stdout

    with open(os.path.join(src, "transforms_train.json")) as f:
        fx = W / (2 * math.tan(json.load(f)["camera_angle_x"] / 2))
    cams = os.path.join(work, "cams.json")
    names = blender_to_camera_json(os.path.join(src, "transforms_train.json"), cams,
                                   [fx, fx, W / 2, H / 2], size=(W, H))

    # 2. the pipeline refuses the random-weights maps at its lift
    try:
        pipeline(lseg_random, cams, os.path.join(work, "refused"))
    except RuntimeError as e:
        if "RANDOM weights" not in str(e):
            raise
        out["refused"] = str(e).split(":")[0]
    else:
        raise AssertionError("the pipeline accepted a random-weights feature directory")

    # 3. seeded unstamped maps of the same views, all five stages
    lseg = os.path.join(work, "lseg_seeded")
    write_seeded_maps(lseg, names, QUERY_CHANNELS, h, w)
    run_work = os.path.join(work, "run")
    reset_k1()
    t0 = time.perf_counter()
    run = pipeline(lseg, cams, run_work)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    launches = k1_launches()
    results["launches"]["pipeline"] = launches
    # stage 5 renders as the render CLI does: K1's indexed variant, no gather,
    # no K3
    if (launches["blend_fwd_indexed"] < len(names) or launches["blend_fwd"] != 0
            or launches["blend_packed"] != 0):
        raise AssertionError(f"stage 5 launched K1 {launches} for {len(names)} views")
    sem = run["semantics"]
    for p in (run["grid_ply"], run["voxel_features"], sem, os.path.join(run_work, "gauss2voxel.npy"),
              sem.replace(".npz", "_gaussians.ply"), sem.replace(".npz", "_voxels.ply")):
        if not os.path.exists(p):
            raise AssertionError(f"the pipeline wrote no {p}")
    labels = np.load(sem)["labels"]
    P = len(PIPELINE_PROMPTS)
    if labels.min() < 0 or labels.max() >= P:
        raise AssertionError(f"labels outside [0, {P})")
    out_dir = os.path.join(model, "train", f"ours_{it}", "semantics")
    for i in range(len(names)):
        lab = load_label_map(os.path.join(out_dir, f"{i:05d}_labels.pt"))
        if lab.shape != (H, W) or lab.min() < 0 or lab.max() >= P:
            raise AssertionError(f"view {i}: label map {lab.shape}, labels outside [0, {P})")
    out["view0_vs_plain"], out["view0_labels_held"] = view0_against_plain(
        src, model, int(it), sem, out_dir)
    out.update(timing=run["timing"], k1_launches=launches, gaussians=len(labels),
               label_histogram=np.bincount(labels, minlength=P).tolist(),
               voxels=int(os.path.basename(run["grid_ply"]).split("_")[1][:-7]))
    results["pipeline"] = out
    log(f"[pipeline] LSeg twin: {len(written)} views at {W}x{H} → {out['lseg_map_shape']} fp16 "
        f"in {out['lseg_cli_s']:.1f} s, stamped random; run_pipeline refused them "
        f"({out['refused']}); on seeded maps: [TIMING] "
        f"{json.dumps({k: round(v, 3) for k, v in run['timing'].items()})}, {out['wall_s']:.1f} s "
        f"wall, {out['voxels']} voxels, K1 launched {launches} times in stage 5, labels "
        f"{out['label_histogram']}; view 0 logits vs plain max abs diff "
        f"{out['view0_vs_plain']:.3g} (fp16 file), labels equal on "
        f"{out['view0_labels_held']} px with top1-top2 > 1e-2")


def phase_query(results, root: str):
    """Phase 9: (a) small, card against CPU; (b) full width; (c) the pipeline."""
    phase_query_small(results)
    phase_query_models(results)
    phase_query_map(results, root)
    phase_pipeline(results, root)


# ──────────── phase 10: pseudo-labels, the LERF-Masked and ScanNet++ protocols ────────────

SLIC_W, SLIC_H = 876, 584               # the lift's and the train step's view
SLIC_FRAMES = 30                        # the hard scene's frames
SLIC_CPU_FRAMES = 3                     # card against CPU on these
SLIC_TIMED = 8                          # segment_image timed and profiled on these
SLIC_AGREE = 0.995
SLIC_STAGES = ("segment.slic", "segment.merge")
EASY_FRAMES = 8                         # the 5-object sweep (K1 at 8 channels)
HARD_RESULT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "hard_scene",
                           "hard_slic_result.json")
# results/hard_scene/hard_slic_result.json's configuration, tracker defaults
HARD_LOOP = dict(frames=30, H=256, W=256, iterations=2000, capacity=8192, n_objects=20,
                 layout="random", textured=True, slic_segments=160, max_per_tile=512, seed=0)
# tests/test_pseudo_label_loop.py's thresholds: (result path, lower or upper bound)
LOOP_GATES = ((("tracker_consistency",), 0.75, "gt"),
              (("post_train_identity_miou_grouped",), 0.25, "gt"),
              (("background_iou",), 0.8, "gt"),
              (("lerf", "lerf_mask_iou"), 0.10, "gt"),
              (("lerf", "control_export_px_frac"), 0.01, "lt"))
MESH_FACES = 1 << 20                    # four chunks of render_scannetpp_gt's 262 144
MESH_VIEWS = 8
MESH_IMAGE = (1752, 1168)               # a ScanNet++ DSLR frame, rendered at 0.5
MESH_DOWNSAMPLE = 0.5
MESH_DEPTH_TIE = 1e-5                   # labels may differ only between nearer-than-this depths


def _hard_objects():
    import numpy as np

    from segsplat_tpu_torch import pseudo_label_loop as L

    return L.build_objects(np.random.default_rng(HARD_LOOP["seed"]),
                           n_objects=HARD_LOOP["n_objects"], layout=HARD_LOOP["layout"],
                           textured=HARD_LOOP["textured"])


def _sweep_kernels(results, g, R, t, fx, fy, label: str):
    """K1 and K2 on one sweep frame's own blend inputs (3 + n_objects channels,
    rasterize's arguments in pseudo_label_loop.render_sweep), K2 with seeded
    cotangents, timed with their bounds."""
    import numpy as np
    import torch

    from segsplat_tpu_torch.ops import blend as B

    n_obj = int(g["oid"].max())
    onehot = np.eye(n_obj, dtype=np.float32)[g["oid"] - 1]
    sc = dict(xyz=g["xyz"], scales=g["scales"], quats=g["quats"], opac=g["opac"],
              logits=np.concatenate([g["rgb"], onehot], axis=1))
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3], vm[:3, 3] = R, t                # world→view: R's rows are the camera axes
    _, bi = blend_inputs_on_card(sc, SLIC_W, SLIC_H, (vm, fx, fy, SLIC_W / 2, SLIC_H / 2),
                                 6, HARD_LOOP["max_per_tile"])
    bg = torch.zeros(3 + n_obj, device="cuda")
    fargs = (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, HARD_LOOP["max_per_tile"])
    img, alpha = B.blend_tiles_plain(*fargs)
    gen = torch.Generator("cuda").manual_seed(3 + n_obj)
    g_img = torch.randn(img.shape, generator=gen, device="cuda")
    g_alpha = torch.randn(alpha.shape, generator=gen, device="cuda")
    return kernels_on_inputs(results, fargs, img, alpha, g_img, g_alpha, label,
                             f"{SLIC_W}x{SLIC_H}")


def phase_slic(results):
    """(b) The GT sweep at 876×584 (K1 at 3 + n_objects channels) and SLIC at
    the CLI's defaults on its frames: card against CPU, the same bits twice,
    ms per frame of segment.slic and segment.merge, one traced frame."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import pseudo_label_loop as L
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.pipeline import segment as S

    out = {}
    for label, g, n in (("sweep5", L.build_objects(np.random.default_rng(0)), EASY_FRAMES),
                        ("sweep20", _hard_objects(), SLIC_FRAMES)):
        Rs, ts, fx, fy = L.orbit_cameras(n, SLIC_H, SLIC_W)
        reset_k1()
        t0 = time.perf_counter()
        rgbs, gts = L.render_sweep(g, Rs, ts, fx, fy, SLIC_H, SLIC_W,
                                   max_per_tile=HARD_LOOP["max_per_tile"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1_launches()
        if sum(launches.values()) != n:
            raise AssertionError(f"[slic] the {label} sweep of {n} frames launched K1 "
                                 f"{launches} times")
        ch = 3 + int(g["oid"].max())
        fwd, bwd = _sweep_kernels(results, g, Rs[0], ts[0], fx, fy, f"slic {label}")
        out[label] = dict(ch=ch, frames=n, launches=launches, ms_per_frame=wall / n * 1e3,
                          objects_seen=int(len(np.unique(gts)) - 1), fwd=fwd, bwd=bwd)
        log(f"[slic] {label}: {n} frames at {SLIC_W}x{SLIC_H}, {ch} channels (K1 width "
            f"{B.kernel_width(ch)}), {wall / n * 1e3:.1f} ms a frame, K1 launched {launches}")
    frames = [(r * 255).astype(np.uint8) for r in rgbs]

    cfg = S.SegmentConfig()                 # prepare_pseudo_label segment's defaults
    gy, gx = S.grid_dims(SLIC_H, SLIC_W, cfg.n_segments)
    as_float = lambda f, dev: torch.as_tensor(f.astype(np.float32) / 255.0, device=dev)
    slic = lambda f, dev: S.slic_labels(as_float(f, dev), gy, gx, cfg.iters, cfg.compactness)
    card = [slic(f, "cuda").cpu().numpy() for f in frames]
    again = [slic(f, "cuda").cpu().numpy() for f in frames]
    if any(not np.array_equal(a, b) for a, b in zip(card, again)):
        raise AssertionError("[slic] two card runs gave different labels")
    agree = []
    for i in range(SLIC_CPU_FRAMES):
        cpu = slic(frames[i], "cpu").numpy()
        differ = int((cpu != card[i]).sum())
        agree.append(dict(frame=i, differ=differ, share=1 - differ / cpu.size))
        if agree[-1]["share"] < SLIC_AGREE:
            raise AssertionError(f"[slic] frame {i}: card and CPU labels differ on {differ} "
                                 f"of {cpu.size} pixels")
    seg = lambda v: S.segment_image(frames[v], cfg, device="cuda")
    seg(0)                                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [seg(v) for v in range(SLIC_TIMED)]
    wall = (time.perf_counter() - t0) / SLIC_TIMED * 1e3
    if min(int(m.min()) for m in ids) < 1:
        raise AssertionError("[slic] segment_image returned an id below 1")
    out["slic"] = dict(n_segments=cfg.n_segments, compactness=cfg.compactness,
                       iters=cfg.iters, grid=[gy, gx], card_vs_cpu=agree,
                       same_bits_twice=True, segment_image_ms_per_frame=wall,
                       regions_per_frame=float(np.mean([m.max() for m in ids])),
                       stages=stage_profile(seg, SLIC_TIMED, SLIC_STAGES),
                       trace=device_trace(lambda v: slic(frames[v], "cuda"), 1))
    log(f"[slic] {SLIC_FRAMES} frames at {SLIC_W}x{SLIC_H} (segment_image on {SLIC_TIMED}): "
        + json.dumps(out["slic"]))
    results["slic"] = out


def _flat(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(d, path):
    for k in path:
        d = d.get(k, {}) if isinstance(d, dict) else {}
    return d if d != {} else None


def phase_loop(results, root: str):
    """(c) The loop twin at the hard scene's configuration on the card, (d)
    render_lerf_mask and eval_lerf_mask on its model directory, and K1 and
    K2 at 19 channels on the trained model's render."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import pseudo_label_loop as L
    from segsplat_tpu_torch.ops import blend as B

    recorded = json.load(open(HARD_RESULT))
    work = os.path.join(root, "hard_scene")
    os.makedirs(work)
    stages = {}

    def counted(name, fn):
        def run(*a, **kw):
            before = dict(k1_launches(), blend_bwd=B.blend_tiles_bwd.launches)
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            after = dict(k1_launches(), blend_bwd=B.blend_tiles_bwd.launches)
            stages[name] = {k: after[k] - before[k] for k in after}
            return r
        return run

    k1_of = lambda stage: stage["blend_fwd"] + stage["blend_fwd_indexed"]
    reset_k1()
    B.blend_tiles_bwd.launches = 0
    t0 = time.perf_counter()
    with swapped(L, render_sweep=counted("sweep", L.render_sweep),
                 train=counted("train", L.train),
                 predict_identity_maps=counted("predict", L.predict_identity_maps)):
        r = L.run_loop(work, quiet=True, save_at=(HARD_LOOP["iterations"],), device="cuda",
                       **HARD_LOOP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k1_launches(), blend_bwd=B.blend_tiles_bwd.launches)
    its, frames = HARD_LOOP["iterations"], HARD_LOOP["frames"]
    if (k1_of(stages["sweep"]) != frames or k1_of(stages["predict"]) != frames
            or min(stages["train"]["blend_fwd"], stages["train"]["blend_bwd"]) < its):
        raise AssertionError(f"[loop] kernel launches by stage {stages}")
    for path, value in _flat(r):
        log(f"[loop] {'.'.join(path)}: {json.dumps(value)} (recorded on the CPU: "
            f"{json.dumps(_get(recorded, path))})")
    for path, limit, how in LOOP_GATES:
        v = _get(r, path)
        if not (v > limit if how == "gt" else v < limit):
            raise AssertionError(f"[loop] {'.'.join(path)} = {v}, limit {how} {limit}")
    timings = dict(r["timings_s"], eval=wall - sum(r["timings_s"].values()), wall=wall)
    results["loop"] = dict(result=r, launches=launches, launches_by_stage=stages,
                           timings_s=timings)
    log(f"[loop] {its} iterations, {frames} frames at {HARD_LOOP['W']}²: {json.dumps(timings)}"
        f"; launches {json.dumps(stages)}")

    # K1 and K2 at 19 channels on the trained model's render of frame 0
    from segsplat_tpu_torch.render import render
    from segsplat_tpu_torch.scene import load_gaussian_table

    table = load_gaussian_table(os.path.join(work, "model", "point_cloud", f"iteration_{its}",
                                             "point_cloud.ply"),
                                capacity=HARD_LOOP["capacity"], device="cuda")
    obj = table.objects_dc.clone().requires_grad_(True)
    table = dataclasses.replace(table, objects_dc=obj)
    Rs, ts, fx, fy = L.orbit_cameras(frames, HARD_LOOP["H"], HARD_LOOP["W"])
    cam = L._camera(Rs[0], ts[0], fx, fy, HARD_LOOP["H"], HARD_LOOP["W"], "cuda")
    out = render(table, cam, torch.zeros(3, device="cuda"), max_tiles_per_axis=6,
                 max_per_tile=HARD_LOOP["max_per_tile"], tile_chunk=16)
    gen = torch.Generator("cuda").manual_seed(19)
    total = sum((out[k] * torch.randn(out[k].shape, generator=gen, device="cuda")).sum()
                for k in ("render", "render_object"))
    cap = {}
    capture_blend(total, cap)
    total.backward()
    offsets, payload, bg, img, alpha = (t.detach() for t in cap["saved"])
    g_img, g_alpha = (torch.zeros_like(x) if g is None else g.detach().contiguous()
                      for g, x in zip(cap["grads"], (img, alpha)))
    fwd, bwd = kernels_on_inputs(results, (offsets, payload, bg, *cap["dims"]), img, alpha,
                                 g_img, g_alpha, "loop", f"{HARD_LOOP['W']}x{HARD_LOOP['H']}")
    results["loop"].update(fwd19=fwd, bwd19=bwd)
    phase_lerf(results, work, its)


def phase_lerf(results, work: str, its: int):
    """(d) render_lerf_mask with frame 0's GT mask of its largest object as the
    query, then eval_lerf_mask of its masks against the GT masks."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    from segsplat_tpu_torch import eval_lerf_mask, render_lerf_mask
    from segsplat_tpu_torch.ops import blend as B

    gts = np.load(os.path.join(work, "merge_debug.npz"))["gts"]
    obj = int(np.bincount(gts[0].ravel())[1:].argmax() + 1)
    query = os.path.join(work, "query.png")
    Image.fromarray((gts[0] == obj).astype(np.uint8) * 255).save(query)
    gt_dir = os.path.join(work, "lerf_gt", "hard")
    os.makedirs(gt_dir)
    for i, gt in enumerate(gts):
        Image.fromarray((gt == obj).astype(np.uint8) * 255).save(
            os.path.join(gt_dir, f"frame_{i:03d}.png"))
    reset_k1()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        render_lerf_mask.main(["-s", work, "-m", os.path.join(work, "model"), "--iteration",
                               str(its), "--query_mask", query, "--device", "cuda"])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = sum(k1_launches().values())
    selected = [ln for ln in buf.getvalue().splitlines() if "selected object ids" in ln]
    masks = os.path.join(work, "model", "test_mask", f"ours_{its}")
    pred_root = os.path.join(work, "lerf_pred")
    os.makedirs(pred_root)
    os.symlink(masks, os.path.join(pred_root, "hard"))
    csv = os.path.join(work, "lerf_eval.csv")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        eval_lerf_mask.main(["--gt_root", os.path.dirname(gt_dir), "--pred_root", pred_root,
                             "--scenes", "hard", "--out_csv", csv])
    rows = open(csv).read().splitlines()
    if launches != len(gts) + 1 or len(rows) != len(gts) + 1:
        raise AssertionError(f"[lerf] K1 launched {launches} times for {len(gts)} views; "
                             f"the CSV holds {len(rows) - 1} masks")
    summary = [ln for ln in buf.getvalue().splitlines() if ln.startswith("ALL")]
    results["lerf"] = dict(object=obj, launches=launches, seconds=render_s,
                           selected=selected, eval=summary,
                           exported_px=int(sum(np.asarray(Image.open(os.path.join(masks, f)))
                                               .astype(bool).sum()
                                               for f in os.listdir(masks) if f.endswith(".png"))))
    log(f"[lerf] render_lerf_mask on the loop's model: {json.dumps(results['lerf'])}")


def room_mesh(n_faces: int = MESH_FACES, seed: int = 0):
    """A seeded annotated mesh of ``n_faces`` triangles in an 8 × 3 × 6 m room:
    its six surfaces tessellated at 5 cm (labels 1-6) and boxes of 0.2-0.8 m
    on the floor and in the air, each surface an n × n grid (labels 7-46),
    cut to ``n_faces``. Every triangle has its own three vertices. Returns
    (verts [3F, 3] float32, faces [F, 3] int32, per-vertex labels [3F] int32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = np.array([-4.0, -1.5, -3.0]), np.array([4.0, 1.5, 3.0])

    def grid(origin, u, v, nu, nv):
        """Triangles [2·nu·nv, 3, 3] of the parallelogram origin + [0,1]u + [0,1]v."""
        a, b = np.meshgrid(np.arange(nu) / nu, np.arange(nv) / nv, indexing="ij")
        p0 = origin + a.reshape(-1, 1) * u + b.reshape(-1, 1) * v
        du, dv = u / nu, v / nv
        return np.concatenate([np.stack([p0, p0 + du, p0 + du + dv], 1),
                               np.stack([p0, p0 + du + dv, p0 + dv], 1)])

    tris, labels = [], []
    ext = hi - lo
    for label, (axis, side) in enumerate(((1, 0), (1, 1), (0, 0), (0, 1), (2, 0), (2, 1)), 1):
        i, j = [a for a in range(3) if a != axis]
        origin = lo.copy()
        origin[axis] = (lo if side == 0 else hi)[axis]
        u, v = np.zeros(3), np.zeros(3)
        u[i], v[j] = ext[i], ext[j]
        t = grid(origin, u, v, int(ext[i] / 0.05), int(ext[j] / 0.05))
        tris.append(t)
        labels.append(np.full(len(t), label))
    count, box = sum(len(t) for t in tris), 0
    while count < n_faces:
        size = rng.uniform(0.2, 0.8, 3)
        while True:                      # keep the camera's 1.2 m around the centre free
            c = rng.uniform(lo + size / 2 + 0.05, hi - size / 2 - 0.05)
            if np.linalg.norm(c[[0, 2]]) > 1.2 + size.max():
                break
        b0 = c - size / 2
        for axis in range(3):
            i, j = [a for a in range(3) if a != axis]
            for side in (0, 1):
                origin = b0.copy()
                origin[axis] += side * size[axis]
                u, v = np.zeros(3), np.zeros(3)
                u[i], v[j] = size[i], size[j]
                t = grid(origin, u, v, 20, 20)
                tris.append(t)
                labels.append(np.full(len(t), 7 + box % 40))
                count += len(t)
        box += 1
    tris = np.concatenate(tris)[:n_faces].astype(np.float32)
    face_labels = np.concatenate(labels)[:n_faces].astype(np.int32)
    verts = tris.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces, np.repeat(face_labels, 3)


def write_mesh_ply(path: str, verts, faces, vlabels) -> None:
    """Binary little-endian PLY: float x, y, z and an int label per vertex,
    triangles as (uchar 3, int indices)."""
    import numpy as np

    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\nproperty float x\nproperty float y\n"
              "property float z\nproperty int label\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    v = np.zeros(len(verts), [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("label", "<i4")])
    v["x"], v["y"], v["z"], v["label"] = verts[:, 0], verts[:, 1], verts[:, 2], vlabels
    f = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
    f["n"], f["i"] = 3, faces
    with open(path, "wb") as fh:
        fh.write(header.encode() + v.tobytes() + f.tobytes())


def mesh_cameras(path: str):
    """MESH_VIEWS cameras at the room's centre, yawing around it, in the stage
    camera JSON (world→camera R, tvec; fx, fy, cx, cy of a 1752×1168 frame)."""
    import numpy as np

    images = {}
    for i in range(MESH_VIEWS):
        yaw, pitch = 2 * np.pi * i / MESH_VIEWS, 0.15 * np.sin(i)
        ry = np.array([[np.cos(yaw), 0, -np.sin(yaw)], [0, 1, 0], [np.sin(yaw), 0, np.cos(yaw)]])
        rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R = rx @ ry
        centre = np.array([0.2 * np.cos(i), 0.1, 0.2 * np.sin(i)])
        images[str(i)] = {"name": f"DSC{i:05d}.JPG", "camera_id": "0", "R": R.tolist(),
                          "tvec": (-R @ centre).tolist()}
    w, h = MESH_IMAGE
    with open(path, "w") as f:
        json.dump({"images": images,
                   "cameras": {"0": {"params": [1200.0, 1200.0, w / 2, h / 2]}}}, f)


def phase_mesh(results, root: str):
    """(e) render_scannetpp_gt on a 1 048 576-face room at 876×584 for 8 views,
    its labels on one view against the CPU's, eval_scannetpp of the GT against
    itself, and tests/test_miou_loop.py's closed loop through K1 at 3 channels."""
    import contextlib
    import io

    import numpy as np
    import torch

    from segsplat_tpu_torch import eval_scannetpp, render_scannetpp_gt
    from segsplat_tpu_torch.eval.metrics import confusion_matrix, iou_per_class
    from segsplat_tpu_torch.io.artifacts import load_label_map
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops.mesh_raster import MISS_LABEL, rasterize_mesh_labels_chunked
    from segsplat_tpu_torch.ops.rasterize import rasterize
    from segsplat_tpu_torch.pipeline.lift_features import load_camera_json

    work = os.path.join(root, "scannetpp")
    os.makedirs(work)
    t0 = time.perf_counter()
    verts, faces, vlabels = room_mesh()
    mesh, cams, gt_dir = (os.path.join(work, n) for n in ("mesh.ply", "cams.json", "gt"))
    write_mesh_ply(mesh, verts, faces, vlabels)
    mesh_cameras(cams)
    setup_s = time.perf_counter() - t0
    w, h = MESH_IMAGE
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        render_scannetpp_gt.main(["--mesh", mesh, "--camera_params", cams, "--image_size",
                                  str(w), str(h), "--downsample", str(MESH_DOWNSAMPLE),
                                  "--out_dir", gt_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_log = buf.getvalue().splitlines()
    warns = [ln for ln in cli_log if ln.startswith("[WARN]")]
    coverage = [ln.strip() for ln in cli_log if "coverage" in ln]
    if len(coverage) != MESH_VIEWS:
        raise AssertionError(f"[mesh] the CLI rendered {len(coverage)} views: {cli_log}")

    # one view on the card, timed, and on the CPU
    entries, params, _ = load_camera_json(cams)
    name = sorted(entries)[0]
    e = entries[name]
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3], vm[:3, 3] = np.asarray(e["R"]), np.asarray(e["tvec"])
    fx, fy, cx, cy = (float(x) * MESH_DOWNSAMPLE for x in params["0"])
    W, H = round(w * MESH_DOWNSAMPLE), round(h * MESH_DOWNSAMPLE)

    def raster(dev):
        return rasterize_mesh_labels_chunked(
            torch.as_tensor(verts, device=dev), torch.as_tensor(faces, device=dev),
            torch.as_tensor(vlabels[::3].copy(), device=dev), torch.as_tensor(vm, device=dev),
            fx, fy, cx, cy, W, H)

    view_ms = cuda_time_ms(lambda: raster("cuda"), reps=3, warmup=1)
    lab, depth, overflow = (x.cpu() for x in raster("cuda"))
    if not np.array_equal(lab.numpy(), load_label_map(os.path.join(gt_dir, f"{name}_labels.pt"))):
        raise AssertionError("[mesh] the CLI's label map differs from the same call's")
    t0 = time.perf_counter()
    c_lab, c_depth, c_over = raster("cpu")
    cpu_s = time.perf_counter() - t0
    differ = lab != c_lab
    tie = (torch.isfinite(depth) & torch.isfinite(c_depth)
           & ((depth - c_depth).abs() <= MESH_DEPTH_TIE * c_depth.abs()))
    if bool((differ & ~tie).any()) or int(overflow) != int(c_over):
        raise AssertionError(f"[mesh] card and CPU labels differ on {int(differ.sum())} "
                             f"pixels, {int((differ & ~tie).sum())} of them no depth tie; "
                             f"overflow {int(overflow)} against {int(c_over)}")
    trace = device_trace(lambda v: raster("cuda"), 1)

    n_cls = int(vlabels.max()) + 1
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        eval_scannetpp.main(["--pred_dir", gt_dir, "--gt_dir", gt_dir, "--num_classes",
                             str(n_cls), "--ignore_label", str(MISS_LABEL)])
    self_eval = buf.getvalue().splitlines()[0]
    if "mIoU 1.0000" not in self_eval:
        raise AssertionError(f"[mesh] GT against itself: {self_eval}")

    # tests/test_miou_loop.py's construction: Gaussians on two labelled quads, K1
    # at 3 channels, against the mesh GT of the quads
    quads = np.array([[-1.4, -0.15], [0.15, 1.4]], np.float32)
    qv = np.concatenate([np.array([[x0, -0.9, 3.0], [x1, -0.9, 3.0], [x1, 0.9, 3.0],
                                   [x0, 0.9, 3.0]], np.float32) for x0, x1 in quads])
    qf = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    qW, qH, qfx = 96, 80, 90.0
    eye = torch.eye(4, device="cuda")
    d = lambda a: torch.as_tensor(a, device="cuda")
    gt = rasterize_mesh_labels_chunked(d(qv), d(qf), d(np.array([1, 1, 2, 2], np.int32)), eye,
                                       qfx, qfx, qW / 2, qH / 2, qW, qH,
                                       max_tiles_per_axis=6, max_per_tile=64,
                                       tile_chunk=5)[0].cpu().numpy()
    xs, ys = np.meshgrid(np.linspace(0, 1, 24), np.linspace(-0.9, 0.9, 24))
    pts = np.concatenate([np.stack([x0 + (x1 - x0) * xs.ravel(), ys.ravel(),
                                    np.full(xs.size, 3.0)], 1) for x0, x1 in quads])
    n = len(pts)
    logits = np.full((n, 3), -10.0, np.float32)
    logits[np.arange(n), np.repeat([1, 2], n // 2)] = 10.0
    reset_k1()
    out = rasterize(d(pts.astype(np.float32)), torch.full((n, 3), 0.05, device="cuda"),
                    d(np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32)),
                    torch.full((n,), 0.95, device="cuda"), d(logits), eye, qfx, qfx,
                    qW / 2, qH / 2, qW, qH, max_tiles_per_axis=6, max_per_tile=128)
    pred = np.where(out["alpha"].cpu().numpy() > 0.5, out["image"].cpu().numpy().argmax(-1),
                    MISS_LABEL)
    mask = gt != MISS_LABEL
    conf = confusion_matrix(np.where(pred == MISS_LABEL, 0, pred)[mask], gt[mask],
                            num_classes=3)
    miou = float(np.nanmean(iou_per_class(conf)[1:]))
    if sum(k1_launches().values()) != 1 or miou <= 0.8:
        raise AssertionError(f"[mesh] mIoU loop: {miou:.4f} with K1 launched "
                             f"{k1_launches()}")
    results["mesh"] = dict(faces=len(faces), views=MESH_VIEWS, size=[W, H],
                           setup_s=setup_s, cli_s=cli_s, cli_s_per_view=cli_s / MESH_VIEWS,
                           view_ms=view_ms, overflow_view0=int(overflow), warnings=len(warns),
                           coverage=coverage, cpu_view_s=cpu_s,
                           card_vs_cpu_differ=int(differ.sum()), trace=trace,
                           self_eval=self_eval, miou_loop=miou)
    log(f"[mesh] {json.dumps(results['mesh'])}")
    for ln in warns:
        log(f"[mesh] {ln}")


# ───────── phase 11: object editing, the inpainters, LPIPS, the offline tools ─────────

EDIT_W, EDIT_H = 876, 584               # the train step's frame (phase 5)
EDIT_SEED = 0
PUSHPULL_TOL = 1e-5                     # push–pull, card against CPU
TEXTURE_TOL = 1e-5                      # PatchMatch, card against CPU: every NNF entry equal
                                        # at every level, the fills within this
LPIPS_RTOL = 1e-4                       # card against CPU
EDIT_FT_ITERS = 50                      # the inpaint twin's finetune
EDIT_TIMED = 10                         # finetune steps timed part by part
CHECKPOINT_AGREE = 0.05                 # tests/test_eval_checkpoint.py's bound
TUNE_RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                             "hard_scene", "tune_class_merge.json")
FT_PARTS = ("render", "loss", "backward", "adam")


def edit_frame(h: int, w: int, seed: int = EDIT_SEED):
    """A seeded textured frame [h, w, 3] in [0, 1]: two crossing sine
    gratings, blocks of flat colour and per-pixel noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (0.5 + 0.2 * np.sin(xx / 5.0 + yy / 11.0)[..., None] * np.array([1.0, 0.6, -0.7])
           + 0.15 * np.sin(yy / 3.0)[..., None] * np.array([0.2, 1.0, 0.5]))
    for _ in range(12):
        y, x = rng.integers(0, h - h // 6), rng.integers(0, w - w // 6)
        img[y:y + h // 8, x:x + w // 8] = rng.random(3)
    img += 0.08 * rng.standard_normal((h, w, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def phase_inpaint(results, root: str):
    """(a) push–pull and PatchMatch at 876×584 on a stroke and a rectangle
    hole, card against CPU, timed, with one traced frame; then the
    inpaint_images twin on the same frames and holes written to disk."""
    import numpy as np
    import torch
    from PIL import Image

    from segsplat_tpu_torch import inpaint_images
    from segsplat_tpu_torch.eval_inpaint_lpips import rect_mask, stroke_mask
    from segsplat_tpu_torch.ops import inpaint_patch as P
    from segsplat_tpu_torch.ops.inpaint import inpaint_pushpull

    img = edit_frame(EDIT_H, EDIT_W)
    holes = {"stroke": stroke_mask(EDIT_H, EDIT_W, np.random.default_rng(EDIT_SEED + 1)),
             "rect": rect_mask(EDIT_H, EDIT_W, np.random.default_rng(EDIT_SEED + 2))}
    out = {}
    for name, hole in holes.items():
        img_t, hole_t = torch.from_numpy(img).to("cuda"), torch.from_numpy(hole).to("cuda")
        pp = inpaint_pushpull(img_t, hole_t, device="cuda").cpu().numpy()
        pp_cpu = inpaint_pushpull(img, hole, device="cpu").numpy()
        pp_err = float(np.abs(pp - pp_cpu).max())
        if not np.isfinite(pp).all() or pp_err > PUSHPULL_TOL:
            raise AssertionError(f"[inpaint] push-pull {name}: card against CPU {pp_err:.3g}")
        pp_ms = cuda_time_ms(lambda: inpaint_pushpull(img_t, hole_t, device="cuda"), reps=5)
        pp_trace = device_trace(lambda v: inpaint_pushpull(img_t, hole_t, device="cuda"), 1)

        t0 = time.perf_counter()
        tex, nnfs = P.inpaint_texture_at(img, hole, P.torch_draws(EDIT_SEED), device="cuda")
        torch.cuda.synchronize()
        tex_first_s = time.perf_counter() - t0
        tex_cpu, nnfs_cpu = P.inpaint_texture_at(img, hole, P.torch_draws(EDIT_SEED),
                                                 device="cpu")
        share = [float((a == b).all(axis=1).mean()) for a, b in zip(nnfs, nnfs_cpu)]
        tex_diff = float(np.abs(tex - tex_cpu)[hole].mean())
        tex_err = float(np.abs(tex - tex_cpu).max())
        err_card = float(np.abs(tex - img)[hole].mean())
        err_cpu = float(np.abs(tex_cpu - img)[hole].mean())
        for label, fill in (("push-pull", pp), ("push-pull CPU", pp_cpu), ("texture", tex),
                            ("texture CPU", tex_cpu)):
            if not np.array_equal(fill[~hole], img[~hole]):
                raise AssertionError(f"[inpaint] {name} {label}: known pixels changed")
        if (not np.isfinite(tex).all() or len(nnfs) != len(nnfs_cpu) or min(share) < 1.0
                or tex_err > TEXTURE_TOL):
            raise AssertionError(f"[inpaint] texture {name}: NNF shares equal {share}, fill "
                                 f"{tex_err:.3g} off the CPU's")
        tex_ms = cuda_time_ms(lambda: P.inpaint_texture(img, hole, device="cuda"), reps=3,
                              warmup=1)
        tex_trace = device_trace(lambda v: P.inpaint_texture(img, hole, device="cuda"), 1)
        out[name] = dict(
            hole_share=float(hole.mean()), hole_px=int(hole.sum()), levels=len(nnfs),
            pushpull=dict(max_abs_err=pp_err, ms=pp_ms, trace=pp_trace,
                          hole_err=float(np.abs(pp - img)[hole].mean())),
            texture=dict(nnf_share_equal=share, max_abs_err=tex_err, hole_mean_abs_diff=tex_diff,
                         hole_err=err_card, hole_err_cpu=err_cpu, ms=tex_ms,
                         first_call_s=tex_first_s, trace=tex_trace))
        log(f"[inpaint] {name} hole ({hole.mean():.3f} of {EDIT_W}x{EDIT_H}): "
            + json.dumps(out[name]))

    # the CLI twin on the same frame under both holes, PatchMatch, with LPIPS
    work = os.path.join(root, "inpaint_cli")
    dirs = {k: os.path.join(work, k) for k in ("images", "masks", "out")}
    for d in dirs.values():
        os.makedirs(d)
    frame = (img * 255).astype(np.uint8)
    for name, hole in holes.items():
        Image.fromarray(frame).save(os.path.join(dirs["images"], f"{name}.png"))
        Image.fromarray(hole.astype(np.uint8) * 255).save(os.path.join(dirs["masks"],
                                                                       f"{name}.png"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        n = inpaint_images.main(["--images", dirs["images"], "--masks", dirs["masks"], "--out",
                                 dirs["out"], "--report_lpips", "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    scores = [ln.strip() for ln in buf.getvalue().splitlines() if "lpips_vgg=" in ln]
    if n != len(holes) or len(scores) != len(holes):
        raise AssertionError(f"[inpaint] the CLI filled {n} frames, scored {len(scores)}")
    for name, hole in holes.items():
        filled = np.asarray(Image.open(os.path.join(dirs["out"], f"{name}.png")))
        dilated = inpaint_images.dilate(hole, 12)           # the CLI's default --dilate
        if not np.array_equal(filled[~dilated], frame[~dilated]) or not (
                filled[hole] != frame[hole]).any():
            raise AssertionError(f"[inpaint] the CLI's {name} fill kept no known pixels or "
                                 f"changed no hole pixel")
    out["cli"] = dict(seconds=cli_s, s_per_frame=cli_s / n, lpips=scores)
    log(f"[inpaint] inpaint_images (patch, --report_lpips) on {n} frames at "
        f"{EDIT_W}x{EDIT_H}: " + json.dumps(out["cli"]))
    results["inpaint"] = out
    return img, tex


def phase_lpips(results, img, fill):
    """(b) LPIPS vgg and alex on a pair of 876×584 frames, card against CPU,
    timed."""
    import torch

    from segsplat_tpu_torch.convert import lpips_from_params
    from segsplat_tpu_torch.eval.lpips import load_lpips, lpips

    out = {}
    a = torch.from_numpy(img).permute(2, 0, 1)[None].to("cuda")
    b = torch.from_numpy(fill).permute(2, 0, 1)[None].to("cuda")
    for net in ("vgg", "alex"):
        params = load_lpips(net=net)
        model = lpips_from_params(params).to("cuda")
        card = lpips(img, fill, model, device="cuda")
        cpu = lpips(img, fill, params, device="cpu")
        rel = abs(card - cpu) / abs(cpu)
        if not math.isfinite(card) or rel > LPIPS_RTOL:
            raise AssertionError(f"[lpips] {net}: card {card} against CPU {cpu}")
        with torch.no_grad():
            ms = cuda_time_ms(lambda: model(a, b), reps=5)
        out[net] = dict(card=card, cpu=cpu, rel_err=rel, ms_per_pair=ms,
                        lins=params["lin_source"], backbone=params["backbone_source"])
        log(f"[lpips] {net} on a {EDIT_W}x{EDIT_H} pair: " + json.dumps(out[net]))
    results["lpips"] = out


def edit_objects(npz: str) -> list:
    """The identity classes of the loop's class maps (``merge_debug.npz``)
    that lie mostly (over half their pixels) on the GT object covering the
    most pixels: codebook indices, as ``--select_obj_id`` takes them."""
    import numpy as np

    d = np.load(npz)
    preds, gts = d["preds"], d["gts"]
    n = d["code_book"].shape[0] + 1                     # the maps hold class + 1, 0 = empty
    target = int(np.bincount(gts[gts > 0]).argmax())
    on_target = np.bincount(preds[gts == target], minlength=n)
    classes = np.flatnonzero((on_target > 0.5 * np.bincount(preds.ravel(), minlength=n))
                             & (np.arange(n) > 0))
    if len(classes) == 0:
        raise AssertionError(f"[edit] no class of the loop's maps lies on GT object {target}")
    return [int(c) - 1 for c in classes]


def phase_edit_clis(results, root: str):
    """(c) The removal twin, the hole masks, inpaint_images and the inpaint
    twin with a 50-step finetune on phase 10c's trained hard scene, whose
    objects render opaque; the finetune step timed part by part and K1/K2 on
    its own inputs."""
    import numpy as np
    import torch
    from PIL import Image

    from segsplat_tpu_torch import edit_object_inpaint, edit_object_removal, inpaint_images
    from segsplat_tpu_torch.io.artifacts import load_codebook
    from segsplat_tpu_torch.io.dataset import resolution_scale_for
    from segsplat_tpu_torch.io.ply import load_gaussian_ply
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.render import raster_backend, render
    from segsplat_tpu_torch.scene import Scene, load_gaussian_table, to_device_camera
    from segsplat_tpu_torch.train.editing import inpaint_setup, mask3d_from_classes

    if "loop" not in results:
        raise AssertionError("[edit] needs phase 10c's trained hard scene (run loop first)")
    its = HARD_LOOP["iterations"]
    src = os.path.join(root, "hard_scene")
    model = os.path.join(src, "model")
    it_dir = os.path.join(model, "point_cloud", f"iteration_{its}")
    table = load_gaussian_table(os.path.join(it_dir, "point_cloud.ply"), device=DEV)
    code_book = load_codebook(os.path.join(it_dir, "classifier.npz"))
    active = table.active.cpu().numpy()
    obj = edit_objects(os.path.join(src, "merge_debug.npz"))
    mask = mask3d_from_classes(table, code_book, obj)
    n_removed = int(mask.sum())
    if n_removed == 0:
        raise AssertionError(f"[edit] classes {obj} hold no Gaussian")
    common = ["-m", model, "--iteration", str(its), "--select_obj_id", *map(str, obj),
              "--device", DEV]

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        path = edit_object_removal.main(["-s", src, *common, "--out_iteration", str(its + 1)])
    removal_s = time.perf_counter() - t0
    kept = load_gaussian_table(path, device=DEV)
    n_kept = int(kept.active.sum())
    keep_rows = torch.from_numpy(active & ~mask).to(DEV)
    if n_kept != int(active.sum()) - n_removed or not torch.equal(kept.xyz[:n_kept],
                                                                  table.xyz[keep_rows]):
        raise AssertionError(f"[edit] removal of classes {obj} ({n_removed} rows): the PLY "
                             f"reloads with {n_kept} of {int(active.sum())} rows")

    # hole masks: the removed rows' own render, alpha > 0.5
    scene = Scene(src, model, shuffle=False, load_iteration=its, device=DEV)
    cams = scene.get_train_cameras()
    scale = resolution_scale_for(cams[0].width, cams[0].height, -1)
    removed_only = dataclasses.replace(table, active=torch.from_numpy(mask).to(DEV))
    masks_dir = os.path.join(root, "edit_masks")
    fills_dir = os.path.join(src, "images_inpaint")      # the finetune's --images
    os.makedirs(masks_dir)
    reset_k1()
    B.blend_tiles_bwd.launches = 0
    hole_px, alpha_max = [], []
    with torch.no_grad():
        for c in cams:
            alpha = render(removed_only, to_device_camera(c, scale, device=DEV),
                           torch.zeros(3, device=DEV))["alpha"]
            hole = (alpha > 0.5).cpu().numpy()
            hole_px.append(int(hole.sum()))
            alpha_max.append(float(alpha.max()))
            Image.fromarray(hole.astype(np.uint8) * 255).save(
                os.path.join(masks_dir, f"{c.image_name}.png"))
    torch.cuda.synchronize()
    mask_launches = k1_launches()
    if sum(hole_px) == 0:
        raise AssertionError(f"[edit] classes {obj}' rows render no hole (alpha max "
                             f"{max(alpha_max):.3f})")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        n_filled = inpaint_images.main(["--images", os.path.join(src, "images"), "--masks",
                                        masks_dir, "--out", fills_dir, "--device", DEV])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if n_filled != len(cams):
        raise AssertionError(f"[edit] inpaint_images filled {n_filled} of {len(cams)} views")
    filled_px = 0
    for c in cams:
        name = os.path.basename(c.image_path)
        before = np.asarray(Image.open(os.path.join(src, "images", name)).convert("RGB"))
        after = np.asarray(Image.open(os.path.join(fills_dir, name)).convert("RGB"))
        filled_px += int((before != after).any(axis=-1).sum())
    if filled_px == 0:
        raise AssertionError("[edit] the fills changed no pixel of the source views")

    # the finetune trains against the fills: the scene's --images images_inpaint
    common = ["-s", src, "--images", "images_inpaint", *common]
    seeded_it, tuned_it = its + 2, its + 3
    with contextlib.redirect_stdout(io.StringIO()):
        seeded_path = edit_object_inpaint.main([*common, "--out_iteration", str(seeded_it)])

    losses = []

    class Recording(edit_object_inpaint.MaskedFinetune):
        def step(self, cam, gt):
            loss = super().step(cam, gt)
            losses.append(loss)
            return loss

    B.blend_tiles.launches = B.blend_tiles_bwd.launches = 0
    t0 = time.perf_counter()
    with swapped(edit_object_inpaint, MaskedFinetune=Recording), \
            contextlib.redirect_stdout(io.StringIO()):
        tuned_path = edit_object_inpaint.main([*common, "--finetune_iters", str(EDIT_FT_ITERS),
                                               "--out_iteration", str(tuned_it)])
    torch.cuda.synchronize()
    inpaint_s = time.perf_counter() - t0
    ft_launches = {"blend_fwd": B.blend_tiles.launches, "blend_bwd": B.blend_tiles_bwd.launches}
    if min(ft_launches.values()) < EDIT_FT_ITERS or len(losses) != EDIT_FT_ITERS:
        raise AssertionError(f"[edit] {EDIT_FT_ITERS} finetune steps launched {ft_launches} "
                             f"({len(losses)} steps)")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"[edit] non-finite finetune losses {losses}")

    # the seeded and the finetuned PLYs: only the new rows moved
    seeded_table, new_rows = inpaint_setup(table, mask)
    new_c = new_rows[seeded_table.active.cpu().numpy()]        # in the PLY's row order
    before, after = load_gaussian_ply(seeded_path), load_gaussian_ply(tuned_path)
    moved = {}
    for k, v in before.items():
        if not np.isfinite(after[k]).all() or not np.array_equal(after[k][~new_c], v[~new_c]):
            raise AssertionError(f"[edit] finetune changed frozen rows of {k}")
        moved[k] = float(np.abs(after[k][new_c] - v[new_c]).max()) if new_c.any() else 0.0
    if not np.array_equal(after["objects_dc"], before["objects_dc"]) or moved["xyz"] == 0.0:
        raise AssertionError(f"[edit] identity features moved or new rows did not: {moved}")
    reloaded = load_gaussian_table(tuned_path, device=DEV)
    if int(reloaded.active.sum()) != len(new_c):
        raise AssertionError("[edit] the finetuned PLY does not reload")

    # one finetune step part by part (CUDA events), and K1/K2 on its inputs
    cam = to_device_camera(cams[0], scale, device=DEV)
    gt = torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(Image.open(os.path.join(fills_dir, f"{cams[0].image_name}.png"))
                   .convert("RGB"), np.float32) / 255.0, (2, 0, 1)))).to(DEV)
    ft = edit_object_inpaint.MaskedFinetune(seeded_table, new_rows, raster_backend(DEV))
    for _ in range(3):
        ft.step(cam, gt)
    parts = {k: [] for k in FT_PARTS}
    for _ in range(EDIT_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(FT_PARTS) + 1)]
        ev[0].record()
        image = ft.render(cam)
        ev[1].record()
        loss = ft.loss(image, gt)
        ev[2].record()
        ft.backward(loss)
        ev[3].record()
        ft.update()
        ev[4].record()
        ev[4].synchronize()
        for i, k in enumerate(FT_PARTS):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    step_ms = {k: statistics.median(v) for k, v in parts.items()}
    step_ms["step"] = sum(step_ms.values())
    out = render(ft.table(), cam, ft.bg, backend=ft.backend)
    total = ft.loss(out["render"], gt)
    cap = {}
    capture_blend(total, cap)
    total.backward()
    fwd, bwd = kernels_on_captured(results, cap, "edit finetune",
                                   f"{HARD_LOOP['W']}x{HARD_LOOP['H']}")

    results["edit"] = dict(
        objects=obj, removed=n_removed, active=int(active.sum()), new_rows=int(new_rows.sum()),
        removal_s=removal_s, hole_px=hole_px, views_with_hole=sum(h > 0 for h in hole_px),
        removed_alpha_max=alpha_max, mask_launches=mask_launches, filled_px=filled_px,
        inpaint_images_s=fill_s, inpaint_images_s_per_view=fill_s / len(cams),
        inpaint_cli_s=inpaint_s, finetune_iters=EDIT_FT_ITERS, launches=ft_launches,
        loss_first=float(losses[0]), loss_last=float(losses[-1]), moved=moved,
        step_ms=step_ms, fwd19=fwd, bwd19=bwd)
    log(f"[edit] classes {obj} of phase 10c's hard scene: " + json.dumps(
        {k: v for k, v in results["edit"].items() if k not in ("fwd19", "bwd19")}))


def phase_offline(results, root: str):
    """(d) rescore, the snapshot's evaluation and the merge sweep on phase 10c's
    run."""
    import numpy as np

    from segsplat_tpu_torch.eval_hard_scene_checkpoint import eval_checkpoint
    from segsplat_tpu_torch.eval_hard_scene_offline import rescore
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.tune_class_merge import best_row, sweep

    work = os.path.join(root, "hard_scene")
    if "loop" not in results:
        raise AssertionError("[offline] needs phase 10c's run (run loop first)")
    r = results["loop"]["result"]
    npz = os.path.join(work, "merge_debug.npz")
    t0 = time.perf_counter()
    got = rescore(npz, HARD_LOOP["n_objects"])
    rescore_s = time.perf_counter() - t0
    keys = ("post_train_identity_miou_grouped", "per_object_iou_grouped",
            "post_train_identity_miou_1to1", "background_iou")
    merge_keys = ("grouped", "strict_1to1", "rendered_classes_before",
                  "rendered_classes_after", "stats")
    differ = [k for k in keys if got[k] != r[k]] + [
        f"class_merge.{k}" for k in merge_keys if got["class_merge"][k] != r["class_merge"][k]]
    if differ:
        raise AssertionError(f"[offline] rescore differs from the loop's results at {differ}")

    reset_k1()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ck = eval_checkpoint(work, HARD_LOOP["iterations"], frames=HARD_LOOP["frames"],
                             size=HARD_LOOP["H"], n_objects=HARD_LOOP["n_objects"],
                             layout=HARD_LOOP["layout"], textured=HARD_LOOP["textured"],
                             seed=HARD_LOOP["seed"], max_per_tile=HARD_LOOP["max_per_tile"],
                             capacity=HARD_LOOP["capacity"], device="cuda")
    checkpoint_s = time.perf_counter() - t0
    gaps = {k: abs(ck[k] - r[k]) for k in ("post_train_identity_miou_grouped",
                                           "post_train_identity_miou_1to1", "background_iou")}
    gaps["class_merge.grouped"] = abs(ck["class_merge"]["grouped"] - r["class_merge"]["grouped"])
    if max(gaps.values()) >= CHECKPOINT_AGREE:
        raise AssertionError(f"[offline] the snapshot's score is off the loop's: {gaps}")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = sweep(npz, HARD_LOOP["n_objects"])
    tune_s = time.perf_counter() - t0
    best = best_row(rows)
    recorded = json.load(open(TUNE_RECORDED))["best"]
    results["offline"] = dict(rescore_s=rescore_s, checkpoint_s=checkpoint_s,
                              checkpoint_launches=k1_launches(), checkpoint_gaps=gaps,
                              tune_s=tune_s, tune_rows=len(rows), tune_best=best,
                              tune_best_recorded=recorded)
    log("[offline] " + json.dumps(results["offline"]))


def phase_edit(results, root: str):
    img, fill = phase_inpaint(results, root)
    phase_lpips(results, img, fill)
    phase_offline(results, root)          # before (c) adds its iterations to the model
    phase_edit_clis(results, root)


# ───────── phase 12: several devices on torch.distributed (one card, one NCCL rank) ─────────

MULTI_B = 4                              # views a step of the B-view step
MULTI_YAWS = (0.0, 0.01, 0.02, 0.03)     # train_camera's yaws of its 4 views
MULTI_TIMED = 10
MULTI_CLI_ITERS = 20
STRIP_W, STRIP_H, STRIPS = 1920, 1024, 4  # 1080 is no multiple of 4·16 (no 1080p strips)
LIFT_SHARD_VIEWS = 8


def multi_batch():
    """The B-view step's inputs at phase 5's width: 4 cameras at train_camera's
    yaws, seeded GT images and perf_train's mask ids (noise: no pixel is
    confident, so the codebook's two losses are 0, as in phase 5)."""
    import numpy as np
    import torch

    from segsplat_tpu_torch.core.types import stack_cameras

    rng = np.random.default_rng(2)
    gts = [torch.as_tensor(rng.random((3, TRAIN_H, TRAIN_W)).astype(np.float32), device=DEV)
           for _ in MULTI_YAWS]
    objs = [torch.as_tensor(rng.integers(0, 32, (TRAIN_H, TRAIN_W)).astype(np.int32),
                            device=DEV) for _ in MULTI_YAWS]
    return stack_cameras([train_camera(y) for y in MULTI_YAWS]), gts, objs


def param_grads(state) -> dict:
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    out = {f: getattr(state.table, f).grad.clone() for f in PARAM_FIELDS
           if getattr(state.table, f).grad is not None}
    out["code_book"] = state.code_book.grad.clone()
    return out


def hold_update(name, got, ref, old, g_ref) -> int:
    """Updated parameters of the kernels' step against the plain one's:
    within two float32 roundings of the parameter wherever the reference
    gradient exceeds the gradient tolerance's atol (Adam's first step is
    ±lr there); elsewhere a gradient within rounding of 0 may take either
    sign and the update ±lr. Returns the count of such elements that part."""
    import torch

    resolved = g_ref.abs() > GRAD_ATOL_REL * float(g_ref.abs().max())
    tol = 2 * torch.finfo(torch.float32).eps * old.abs() + 1e-6 * (ref - old).abs()
    bad = resolved & ((got - ref).abs() > tol)
    if bool(bad.any()):
        raise AssertionError(f"B-view step 1 {name}: {int(bad.sum())} updated entries "
                             f"part from the plain step where the gradient is resolved")
    return int(((got != ref) & ~resolved).sum())


def phase_multi_step(results, mesh):
    """(b) The B-view step on the 1×1 NCCL mesh at phase 5's width."""
    import torch

    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.parallel import train as PTR
    from segsplat_tpu_torch.parallel.mesh import Mesh
    from segsplat_tpu_torch.train import losses as L
    from segsplat_tpu_torch.train import trainer as T
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    pts, cols, _, _ = train_scene()
    table0 = T.init_table_from_pcd(pts, cols, TRAIN_CAP, max_sh_degree=3, seed=0, device=DEV)
    cfg = T.OptimizationConfig(num_classes=256)
    raster_kw = dict(max_tiles_per_axis=3, max_per_tile=256)
    cams, gts, objs = multi_batch()
    bg = torch.zeros(3, device=DEV)
    idx = torch.randint(0, TRAIN_W * TRAIN_H, (MULTI_B, L.CONTRAST_SAMPLES),
                        generator=torch.Generator(DEV).manual_seed(0), device=DEV)

    def fresh():
        table = dataclasses.replace(table0, **{f: getattr(table0, f).detach().clone()
                                               for f in PARAM_FIELDS})
        return T.init_state(table, cfg, spatial_lr_scale=3.0, seed=0)

    def step1(step_mesh, plain=False, update=True):
        """Step 1 from the initial state: (state, metrics, grads, captured blend)."""
        state = fresh()
        captured = {}
        swaps = [swapped(B, blend_tiles=B.blend_tiles_plain,
                         blend_tiles_bwd=B.blend_tiles_bwd_plain) if plain
                 else contextlib.nullcontext(),
                 contextlib.nullcontext() if update
                 else swapped(T, apply_updates=lambda s: None)]
        orig_compute = T.compute_losses

        def capture_first(*a, **k):
            total, aux = orig_compute(*a, **k)
            if not captured:
                capture_blend(total, captured)
            return total, aux

        with swaps[0], swaps[1], swapped(T, compute_losses=capture_first):
            m = PTR.make_parallel_train_step(cfg, step_mesh, raster_kw)(
                state, cams, gts, objs, bg, idx=idx)
            torch.cuda.synchronize()
        return state, {k: float(v) for k, v in m.items()}, param_grads(state), captured

    B.blend_tiles.launches = B.blend_tiles_bwd.launches = 0
    got, got_m, got_g, cap = step1(mesh)
    step_launches = {"blend_fwd": B.blend_tiles.launches, "blend_bwd": B.blend_tiles_bwd.launches}
    if step_launches != {"blend_fwd": MULTI_B, "blend_bwd": MULTI_B}:
        raise AssertionError(f"a {MULTI_B}-view step launched {step_launches}")
    ref, ref_m, ref_g, _ = step1(mesh, plain=True)
    for k, v in ref_m.items():
        if not (math.isfinite(got_m[k]) and abs(got_m[k] - v) <= 1e-4 * abs(v) + 1e-9):
            raise AssertionError(f"B-view step 1 {k}: kernels {got_m[k]} vs plain {v}")
    grad_err = {k: compare_grad(f"B-view step 1 grad {k}", got_g[k], ref_g[k]) for k in ref_g}
    old = fresh()
    flips = {}
    for f in PARAM_FIELDS:
        if f in ref_g:
            flips[f] = hold_update(f, getattr(got.table, f).detach(),
                                   getattr(ref.table, f).detach(),
                                   getattr(old.table, f).detach(), ref_g[f])
    del ref, old
    # the gradient against two ranks' shares computed in turn and added by hand
    shares = [step1(Mesh(2, 1, r, 0), update=False)[2] for r in range(2)]
    split_err = {k: compare_grad(f"B-view step two-rank split {k}", shares[0][k] + shares[1][k],
                                 got_g[k]) for k in got_g}
    del shares, got
    log(f"[multi] B={MULTI_B} step 1, kernels vs plain: {json.dumps(got_m)}; grad max abs diff "
        f"{json.dumps(grad_err)}; updates parted only at unresolved gradients: "
        f"{json.dumps(flips)}; two-rank split vs the step: {json.dumps(split_err)}")
    results["multi_fwd"], results["multi_bwd"] = kernels_on_captured(results, cap, "multi")
    del cap

    # 10 steps timed part by part: render and losses (compute_losses less the
    # render), the all-reduce, the optimizers; the backward is the rest
    spans = {}

    def timed(name, fn):
        def run(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans.setdefault(name, []).append(ev)
            return out
        return run

    state = fresh()
    step_fn = PTR.make_parallel_train_step(cfg, mesh, raster_kw)
    gen = torch.Generator(DEV).manual_seed(1)
    warm, rows, wall = 2, [], []
    with swapped(T, render=timed("render", T.render),
                 compute_losses=timed("compute_losses", T.compute_losses),
                 apply_updates=timed("optimizers", T.apply_updates)), \
            swapped(PTR, _flat_all_reduce=timed("all_reduce", PTR._flat_all_reduce)):
        for i in range(warm + MULTI_TIMED):
            if i == warm:
                B.blend_tiles.launches = B.blend_tiles_bwd.launches = 0
            spans.clear()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            ev[0].record()
            m = step_fn(state, cams, gts, objs, bg, generator=gen)
            ev[1].record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            if not all(math.isfinite(float(v)) for v in m.values()):
                raise AssertionError(f"B-view step {i}: non-finite metrics {m}")
            span = {k: sum(e[0].elapsed_time(e[1]) for e in v) for k, v in spans.items()}
            step = ev[0].elapsed_time(ev[1])
            rows.append(dict(step=step, render=span["render"],
                             losses=span["compute_losses"] - span["render"],
                             all_reduce=span["all_reduce"], optimizers=span["optimizers"],
                             backward=step - span["compute_losses"] - span["all_reduce"]
                             - span["optimizers"]))
    launches = {"blend_fwd": B.blend_tiles.launches, "blend_bwd": B.blend_tiles_bwd.launches}
    if launches != {k: MULTI_B * MULTI_TIMED for k in launches}:
        raise AssertionError(f"{MULTI_TIMED} timed {MULTI_B}-view steps launched {launches}")
    med = {k: statistics.median(r[k] for r in rows[warm:]) for k in rows[0]}
    med["wall"] = statistics.median(wall[warm:])
    single = results.get("train_step", {}).get("median_ms", {}).get("step")
    results["multi_step"] = dict(
        B=MULTI_B, median_ms=med, steps=MULTI_TIMED, launches=launches,
        single_view_step_ms=single, four_single_view_steps_ms=single and MULTI_B * single,
        num_pairs=int(m["num_pairs"]), tile_overflow=int(m["tile_overflow"]),
        total=float(m["total"]), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[multi] B={MULTI_B} step at {TRAIN_W}x{TRAIN_H}, capacity {TRAIN_CAP}, m=3, K=256, "
        f"1x1 NCCL mesh: " + json.dumps(results["multi_step"]))
    del state, table0
    torch.cuda.empty_cache()


def torchrun_train(root: str, argv: list, tag: str):
    """``torchrun --standalone --nproc_per_node 1`` of this script's train child,
    which runs the CLI twin's main (``python -m segsplat_tpu_torch.train``)
    and writes the blends' launch counts: (returncode, stdout, stderr, counts)."""
    out = os.path.join(root, f"{tag}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--train-child", out, *argv]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    counts = json.load(open(out)) if os.path.exists(out) else None
    return r.returncode, r.stdout, r.stderr, counts


def train_child(out: str, argv: list) -> int:
    """The rank process of ``torchrun_train``: the CLI twin's main, then the
    blends' launches, the step and the world into ``out``."""
    import torch.distributed as dist

    from segsplat_tpu_torch.ops.blend import blend_tiles, blend_tiles_bwd
    from segsplat_tpu_torch.train import cli

    blend_tiles.launches = blend_tiles_bwd.launches = 0
    stdout = sys.stdout
    try:
        state = cli.main(argv)
    finally:
        sys.stdout = stdout
    with open(out, "w") as f:
        json.dump({"blend_fwd": blend_tiles.launches, "blend_bwd": blend_tiles_bwd.launches,
                   "step": state.step, "active": int(state.table.active.sum()),
                   "initialized_after": dist.is_initialized()}, f)
    return 0


def phase_multi_cli(results, root: str):
    """(c) The train CLI twin under torchrun with --view_batch 4."""
    import torch

    from segsplat_tpu_torch.scene import load_gaussian_table

    src = write_train_scene(os.path.join(root, "multi_scene"), n_views=MULTI_B)
    model = os.path.join(root, "multi_model")
    argv = ["-s", src, "-m", model, "--iterations", str(MULTI_CLI_ITERS),
            "--capacity", str(TRAIN_CAP), "--view_batch", str(MULTI_B),
            "--densify_from_iter", "5", "--densification_interval", "10",
            "--densify_until_iter", str(MULTI_CLI_ITERS), "--opacity_reset_interval", "15",
            "--test_iterations", str(MULTI_CLI_ITERS), "--device", DEV]
    t0 = time.perf_counter()
    rc, out, err, counts = torchrun_train(root, argv, "multi_cli")
    cli_s = time.perf_counter() - t0
    if rc != 0 or counts is None:
        raise AssertionError(f"torchrun train CLI exit {rc}:\n{out[-3000:]}\n{err[-5000:]}")
    if min(counts["blend_fwd"], counts["blend_bwd"]) < MULTI_B * MULTI_CLI_ITERS:
        raise AssertionError(f"{MULTI_CLI_ITERS} iterations of {MULTI_B} views launched {counts}")
    if counts["initialized_after"]:
        raise AssertionError("the CLI left its process group open")
    metrics = [json.loads(line) for line in open(os.path.join(model, "metrics.jsonl"))]
    steps = [m for m in metrics if "total" in m]
    evals = [m for m in metrics if "eval_psnr" in m]
    bad = [(m["iter"], k) for m in steps + evals for k, v in m.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if len(steps) != MULTI_CLI_ITERS // 10 or not evals or bad:
        raise AssertionError(f"metrics.jsonl: {len(steps)} steps, {len(evals)} evals, "
                             f"non-finite {bad}")
    ply = os.path.join(model, "point_cloud", f"iteration_{MULTI_CLI_ITERS}", "point_cloud.ply")
    reloaded = load_gaussian_table(ply, capacity=TRAIN_CAP, device=DEV)
    if int(reloaded.active.sum()) != counts["active"] or not bool(
            torch.isfinite(reloaded.xyz).all()):
        raise AssertionError(f"the PLY reloads {int(reloaded.active.sum())} rows, the run "
                             f"ended with {counts['active']}")
    # a mesh larger than the world is refused, naming both sizes
    rc2, _, err2, _ = torchrun_train(root, argv[:4] + ["--iterations", "1", "--mesh_tensor",
                                                       "2", "--device", DEV], "multi_cli_t2")
    if rc2 == 0 or "view=1 x tensor=2 needs 2 ranks" not in err2:
        raise AssertionError(f"--mesh_tensor 2 at world 1: exit {rc2}, stderr {err2[-2000:]}")
    results["multi_cli"] = dict(seconds=cli_s, launches=counts, last=steps[-1], eval=evals[-1],
                                num_gaussians=counts["active"], mesh_tensor_2="ValueError")
    log(f"[multi-cli] torchrun --nproc_per_node 1 -m segsplat_tpu_torch.train --view_batch "
        f"{MULTI_B}: {MULTI_CLI_ITERS} iterations in {cli_s:.1f} s, launches {counts}; last "
        f"{json.dumps(steps[-1])}; eval {json.dumps(evals[-1])}; PLY reloads; "
        f"--mesh_tensor 2 at world 1 raises ValueError")


def phase_multi_lift(results, mesh):
    """(d) lift_views_sharded at phase 8's officescene scale on the 1×1 mesh."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import bench
    from segsplat_tpu_torch.ops import lift as PL
    from segsplat_tpu_torch.parallel import lift_views_sharded
    from segsplat_tpu_torch.parallel.mesh import Mesh
    from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, lift_grid, resize_features

    sc = bench.officescene_lift_scene(n_views=LIFT_SHARD_VIEWS)
    W, H, C = sc["W"], sc["H"], sc["C"]
    cfg = LiftConfig()
    f32 = dict(dtype=torch.float32, device=DEV)
    _, occ, occ_origin, _, _ = lift_grid(sc["centers"], sc["vs"], sc["origin"],
                                         sc["grid_shape"], DEV)
    num_ids = len(sc["centers"]) + 1
    feats = torch.stack([resize_features(torch.as_tensor(m, device=DEV), H, W).permute(1, 2, 0)
                         for m in sc["feats"]])                           # [8, H, W, 512]
    c2ws, intr = torch.as_tensor(sc["c2ws"], **f32), torch.as_tensor(sc["intr"], **f32)
    inc = sc["vs"] * cfg.ray_increment_factor
    fx, fy, cx, cy = (float(x) for x in sc["intr"][0])
    steps = PL.default_max_steps(W, H, fx, fy, cfg.depth_min, cfg.depth_max, inc, cx=cx, cy=cy)
    geo = (occ, c2ws, intr, torch.as_tensor(occ_origin, **f32), torch.tensor(sc["vs"], **f32),
           cfg.depth_min, cfg.depth_max)

    def sharded(m):
        return lift_views_sharded(m, feats, *geo, inc, num_ids, steps)

    ref_s, ref_c = PL.lift_views_scan(feats, *geo, torch.tensor(inc, **f32), num_ids, steps,
                                      W, H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_s, got_c = sharded(mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    halves = [sharded(Mesh(2, 1, r, 0)) for r in range(2)]
    checks = {}
    for name, (s, c) in (("1x1 mesh", (got_s, got_c)),
                         ("halves in turn", (halves[0][0] + halves[1][0],
                                             halves[0][1] + halves[1][1]))):
        if not torch.equal(c, ref_c):
            raise AssertionError(f"sharded lift {name}: counts part from lift_views_scan")
        err = float((s - ref_s).abs().max())
        if float(((s - ref_s).abs() - (1e-5 + 1e-5 * ref_s.abs())).max()) > 0:
            raise AssertionError(f"sharded lift {name}: sums part by {err:.3g}")
        checks[name] = err
    hit = int((ref_c[1:] > 0).sum())
    results["multi_lift"] = dict(views=LIFT_SHARD_VIEWS, views_per_sec=LIFT_SHARD_VIEWS / secs,
                                 seconds=secs, voxels_hit=hit, sums_max_abs_diff=checks,
                                 shape=[W, H, C, len(sc["centers"])])
    log(f"[multi-lift] lift_views_sharded, {LIFT_SHARD_VIEWS} views of {W}x{H}x{C} into "
        f"{len(sc['centers'])} voxels on the 1x1 NCCL mesh: " + json.dumps(results["multi_lift"]))
    del feats, ref_s, got_s, halves
    torch.cuda.empty_cache()


def phase_multi_strips(results, mesh):
    """(e) The headline scene at 1920×1024 in 4 strips and as one frame."""
    import torch

    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops.rasterize import TILE, build_blend_inputs, project_gaussians, rasterize
    from segsplat_tpu_torch.parallel import rasterize_sharded
    from segsplat_tpu_torch.parallel.render import rasterize_strip, strip_height

    sc = bench_scene("headline")
    m, K = sc["m"], sc["K"]
    vm, fx, fy, cx, cy = bench_camera(STRIP_W, STRIP_H)
    t = {k: torch.as_tensor(sc[k], device=DEV) for k in ("xyz", "scales", "quats", "opac",
                                                          "logits")}
    args = (t["xyz"], t["scales"], t["quats"], t["opac"], t["logits"],
            torch.as_tensor(vm, device=DEV), fx, fy, cx, cy, STRIP_W, STRIP_H)
    bg = torch.zeros(32, device=DEV)
    kw = dict(bg=bg, max_tiles_per_axis=m, max_per_tile=K)
    reset_k1()
    whole = rasterize(*args, **kw)
    shard = rasterize_sharded(mesh, *args, **kw)
    strips = [rasterize_strip(i, STRIPS, *args, **kw) for i in range(STRIPS)]
    torch.cuda.synchronize()
    launches = k1_launches()
    if sum(launches.values()) != 2 + STRIPS:
        raise AssertionError(f"the frame, the 1x1 sharded frame and {STRIPS} strips launched "
                             f"K1 {launches} times")
    errs = {"rasterize_sharded 1x1": compare("rasterize_sharded", (shard["image"],
                                             shard["alpha"]), (whole["image"], whole["alpha"])),
            "strips in turn": compare("strips", (torch.cat([s["image"] for s in strips]),
                                                 torch.cat([s["alpha"] for s in strips])),
                                      (whole["image"], whole["alpha"]))}
    results["fwd_err"] = max(results["fwd_err"], *errs.values())
    whole_ms = cuda_time_ms(lambda: rasterize(*args, **kw), reps=5)
    strip_ms = [cuda_time_ms(lambda i=i: rasterize_strip(i, STRIPS, *args, **kw), reps=5)
                for i in range(STRIPS)]
    # K1 on each strip's own blend inputs, with its bound
    strip_h = strip_height(STRIP_H, STRIPS)
    per_strip = []
    for i in range(STRIPS):
        proj = project_gaussians(*args[:3], args[5], fx, fy, cx, cy, STRIP_W, strip_h,
                                 tan_fovx=(0.5 * STRIP_W) / fx, tan_fovy=(0.5 * STRIP_H) / fy,
                                 row0=i * strip_h)
        bi = build_blend_inputs(proj, t["logits"], t["opac"], STRIP_W, strip_h, m, K,
                                tile_row0=i * strip_h // TILE)
        fargs = (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, K)
        got = B.blend_tiles(*fargs)
        r_img, r_alpha, rows, hits, _ = B.blend_tiles_plain_with_work(*fargs)
        err = compare(f"strip {i} K1", got, (r_img, r_alpha))
        entry = dict(strip=i, num_pairs=int(bi.num_pairs), max_abs_err=err,
                     ms=cuda_time_ms(lambda: B.blend_tiles(*fargs), reps=10),
                     plain_ms=cuda_time_ms(lambda: B.blend_tiles_plain(*fargs), reps=3, warmup=1),
                     rasterize_ms=strip_ms[i], rows_read=rows, pixels_hit=hits)
        entry["bound_ms"], entry["bound_by"], entry["ops"], entry["bytes"] = k1_bound(
            bi.offsets, rows, hits, 32, bi.tx_n * bi.ty_n)
        per_strip.append(entry)
        del got, r_img, r_alpha, bi, proj
    heaviest = max(per_strip, key=lambda e: e["num_pairs"])
    results["multi_strips"] = dict(size=[STRIP_W, STRIP_H], strips=STRIPS, m=m, K=K,
                                   launches=launches, max_abs_err=errs, whole_ms=whole_ms,
                                   strip_rasterize_ms=strip_ms, per_strip=per_strip,
                                   heaviest=heaviest)
    log(f"[multi-strips] headline scene at {STRIP_W}x{STRIP_H}, {STRIPS} strips: "
        + json.dumps(results["multi_strips"]))
    del t, whole, shard, strips
    torch.cuda.empty_cache()


def phase_multi(results, root: str):
    """Phase 12: (a) topology on an NCCL group of one rank; (b) the B-view step;
    (c) the train CLI under torchrun; (d) the sharded lift; (e) strips."""
    import torch.distributed as dist

    from segsplat_tpu_torch.parallel import make_mesh, multihost

    topo = multihost.initialize(f"file://{os.path.join(root, 'rendezvous')}", 1, 0,
                                backend="nccl")
    try:
        mesh = make_mesh()
        if mesh.groups is None or dist.get_backend() != "nccl":
            raise AssertionError(f"phase 12 runs on an NCCL group, got {topo}")
        log(f"[multi] topology {json.dumps(topo)}; mesh view={mesh.n_view} "
            f"tensor={mesh.n_tensor}")
        seconds = {}
        for name, fn in (("step", lambda: phase_multi_step(results, mesh)),
                         ("cli", lambda: phase_multi_cli(results, root)),
                         ("lift", lambda: phase_multi_lift(results, mesh)),
                         ("strips", lambda: phase_multi_strips(results, mesh))):
            t0 = time.perf_counter()
            fn()
            seconds[name] = time.perf_counter() - t0
        log(f"[multi] parts in s: {json.dumps(seconds)}")
    finally:
        dist.destroy_process_group()


# ──────── phase 13: the SIBR viewer, the host-script twins and check_env ────────
VIEWER_SIZES = ((TRAIN_W, TRAIN_H), (FRAME_W, FRAME_H))
VIEWER_SCALES = (1.0, 0.5)
VIEWER_FOV_X = 1.2              # train_camera's horizontal field of view
VIEWER_TIMEOUT = 120.0          # every socket and thread join of phase 13
TOOLS_CLI_ITERS = 10
TOOLS_VIEWS = 1                 # the views prepare_tensor_data packs at full width: one keeps
#                                 13c's CPU sides short (its DDA took 30.5 s for two)
RESIZE_TOL = 1e-5               # prepare_tensor_data's resize, card against CPU


def viewer_message(w: int, h: int, scale: float = 1.0, train: bool = True,
                   keep_alive: bool = True) -> bytes:
    """A SIBR camera message on the wire for train_camera(0.0)'s pose (R = I,
    T = 0), fov_x 1.2 and fov_y to the aspect; w = 0 asks for no frame. The
    row-vector view matrix carries the Y/Z flip that receive() undoes."""
    fov_y = 2 * math.atan(math.tan(VIEWER_FOV_X / 2) * h / w) if w else 0.0
    msg = {"resolution_x": w, "resolution_y": h, "train": train, "keep_alive": keep_alive,
           "fov_x": VIEWER_FOV_X, "fov_y": fov_y, "z_near": 0.01, "z_far": 100.0,
           "shs_python": False, "rot_scale_python": False, "scaling_modifier": scale,
           "view_matrix": [1.0, 0, 0, 0, 0, -1.0, 0, 0, 0, 0, -1.0, 0, 0, 0, 0, 1.0],
           "view_projection_matrix": [1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0]}
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def viewer_reply(sock, n_image: int):
    """(image bytes, verify string) of one reply of the viewer."""
    def exact(n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
            if not chunk:
                raise ConnectionError("the viewer closed the connection")
            buf += chunk
        return bytes(buf)
    img = exact(n_image)
    return img, exact(int.from_bytes(exact(4), "little")).decode("ascii")


class ViewerClient:
    """A viewer client thread: connects to ``port`` (retrying until the server
    listens), runs ``script(sock, replies)``; ``join`` fails if it hung or
    raised."""

    def __init__(self, port: int, script):
        import threading

        self.replies, self.error, self.port, self.script = [], None, port, script
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import socket

        try:
            deadline = time.monotonic() + VIEWER_TIMEOUT
            while True:
                try:
                    sock = socket.create_connection(("127.0.0.1", self.port),
                                                    timeout=VIEWER_TIMEOUT)
                    break
                except ConnectionRefusedError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            with sock:
                self.script(sock, self.replies)
        except Exception as e:          # raised again by join()
            self.error = e

    def join(self):
        self.thread.join(timeout=VIEWER_TIMEOUT)
        if self.thread.is_alive():
            raise AssertionError("a viewer client hung")
        if self.error is not None:
            raise AssertionError(f"a viewer client failed: {self.error!r}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_client(gui, table, bg, script, verify: str):
    """One client of ``gui``: wait for it, then one poll_and_render. Returns
    (the poll's do_training, the client's replies)."""
    if gui.conn is not None:            # the previous client's, closed at its end
        gui.conn.close()
    client = ViewerClient(gui.listener.getsockname()[1], script)
    deadline = time.monotonic() + VIEWER_TIMEOUT
    while not gui.try_connect():
        if time.monotonic() > deadline:
            raise AssertionError("no viewer client connected")
        time.sleep(0.01)
    do_training = gui.poll_and_render(table, True, verify, bg=bg)
    client.join()
    return do_training, client.replies


def phase_viewer(results):
    """(a) NetworkGUI.poll_and_render over loopback on phase 5's 200 000-point
    train table: frames at 876×584 and 1920×1080, scaling_modifier 1.0 and
    0.5, each against the same render on K1's plain version; a client that
    pauses and resumes, one that drops mid-message, and the next one served;
    K1 launches equal to the frames served; K1 on the 1080p frame's inputs."""
    import numpy as np
    import torch

    from segsplat_tpu_torch import viewer as PV
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops import rasterize as Rz
    from segsplat_tpu_torch.train import trainer as T

    pts, cols, _, _ = train_scene()
    table = T.init_table_from_pcd(pts, cols, TRAIN_CAP, max_sh_degree=3, seed=0, device=DEV)
    table = T.init_state(table, T.OptimizationConfig(num_classes=256), spatial_lr_scale=3.0,
                         seed=0).table          # the training table, which requires grad
    bg = torch.zeros(3, device=DEV)
    plan = [(w, h, s) for w, h in VIEWER_SIZES for s in VIEWER_SCALES]
    frames, renders = [], []          # per served frame: spans; (camera, scale)
    real_render, real_bytes = PV.render, PV.frame_bytes

    def timed_render(table, cam, bg, scaling_modifier):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_render(table, cam, bg, scaling_modifier=scaling_modifier)
        ev[1].record()
        ev[1].synchronize()
        renders.append((cam, scaling_modifier))
        frames.append(dict(size=f"{cam.width}x{cam.height}", scale=scaling_modifier,
                           render_ms=ev[0].elapsed_time(ev[1]),
                           num_pairs=int(out["num_pairs"]),
                           tile_overflow=int(out["tile_overflow"])))
        return out

    def timed_bytes(img):
        t = time.perf_counter()
        data = real_bytes(img)
        frames[-1].update(copy_ms=(time.perf_counter() - t) * 1e3, bytes=len(data))
        return data

    gui = PV.NetworkGUI()
    gui.init("127.0.0.1", 0)
    real_send = gui.send

    def timed_send(image, verify):
        t = time.perf_counter()
        real_send(image, verify)
        if image is not None:
            frames[-1]["socket_ms"] = (time.perf_counter() - t) * 1e3

    gui.send = timed_send

    def frames_client(sock, replies):
        for w, h, s in plan:
            sock.sendall(viewer_message(w, h, s))
            replies.append(viewer_reply(sock, w * h * 3))
        sock.sendall(viewer_message(0, 0))                 # no camera: training goes on
        replies.append(viewer_reply(sock, 0))

    def pausing_client(sock, replies):
        sock.sendall(viewer_message(TRAIN_W, TRAIN_H, train=False))
        replies.append(viewer_reply(sock, TRAIN_W * TRAIN_H * 3))
        sock.sendall(viewer_message(TRAIN_W, TRAIN_H, train=True, keep_alive=False))
        replies.append(viewer_reply(sock, TRAIN_W * TRAIN_H * 3))

    def dropping_client(sock, replies):
        sock.sendall(viewer_message(TRAIN_W, TRAIN_H)[:40])   # then the socket closes

    def one_frame_client(sock, replies):
        sock.sendall(viewer_message(TRAIN_W, TRAIN_H, keep_alive=False))
        replies.append(viewer_reply(sock, TRAIN_W * TRAIN_H * 3))

    stdout = io.StringIO()
    reset_k1()
    try:
        with swapped(PV, render=timed_render, frame_bytes=timed_bytes), \
                contextlib.redirect_stdout(stdout):
            served = {}
            for name, script in (("frames", frames_client), ("pause", pausing_client),
                                 ("drop", dropping_client), ("next", one_frame_client)):
                do_training, served[name] = serve_client(gui, table, bg, script, name)
                if not do_training or gui.conn is not None and name == "drop":
                    raise AssertionError(f"viewer client {name}: the poll returned "
                                         f"do_training={do_training}, conn={gui.conn}")
            torch.cuda.synchronize()
            launches = k1_launches()
    finally:
        gui.close()
    got_frames = [r for name in ("frames", "pause", "next") for r in served[name] if r[0]]
    if not sum(launches.values()) == len(frames) == len(got_frames) == len(plan) + 3:
        raise AssertionError(f"{len(frames)} frames served, {len(got_frames)} received, "
                             f"K1 launched {launches} times")
    for name, (_, verify) in ((n, r) for n in served for r in served[n]):
        if verify != name:
            raise AssertionError(f"viewer client {name} read the verify string {verify!r}")

    # each frame against the same render on K1's plain version, converted alike
    captured = {}

    def plain(*fargs):
        captured["fargs"] = fargs
        return B.blend_tiles_plain(*fargs)

    def plain_indexed(offsets, ids, rows, bg, tx_n, ty_n, K):
        # the no-grad render's K1 reads rows[ids]: the same payload, gathered
        return plain(offsets, torch.nn.functional.pad(rows[ids], (0, 0, 0, K)), bg,
                     tx_n, ty_n, K)

    diffs = []
    for i, (cam, scale) in enumerate(renders):
        with swapped(B, blend_tiles=plain), swapped(Rz, blend_tiles_indexed=plain_indexed), \
                torch.no_grad():
            ref = np.frombuffer(real_bytes(real_render(table, cam, bg,
                                                       scaling_modifier=scale)["render"]),
                                np.uint8)
        got = np.frombuffer(got_frames[i][0], np.uint8)
        delta = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        diffs.append(dict(max_lsb=int(delta.max()), bytes_differ=int((delta > 0).sum())))
        frames[i].update(diffs[-1])
        if delta.max() > 1:
            raise AssertionError(f"viewer frame {i} ({frames[i]['size']}, scale {scale}) "
                                 f"parts from the plain blend by {int(delta.max())} LSB")
        if i == plan.index((FRAME_W, FRAME_H, 1.0)):
            fargs = captured["fargs"]
    k1 = k1_on_inputs(results, fargs, "viewer", f"{FRAME_W}x{FRAME_H}")
    results["viewer"] = dict(frames=frames, launches=launches, k1_1080p=k1,
                             clients={k: len(v) for k, v in served.items()})
    for f in frames:
        log(f"[viewer] frame {json.dumps(f)}")
    log(f"[viewer] {len(frames)} frames served to 4 clients (a pause and resume, a drop "
        f"mid-message, the next client served), K1 launched {launches}; every frame "
        f"within {max(d['max_lsb'] for d in diffs)} LSB of the plain blend "
        f"({sum(d['bytes_differ'] for d in diffs)} bytes differ)")
    del table
    torch.cuda.empty_cache()


def phase_viewer_cli(results, root: str):
    """(b) ``python -m segsplat_tpu_torch.train --port P`` for 10 iterations at
    phase 6's configuration, a client fetching one 876×584 frame; a second
    launch on a port that is already bound warns and trains."""
    import socket

    import torch

    from segsplat_tpu_torch.train import cli

    src = os.path.join(root, "train_scene")
    if not os.path.exists(src):
        write_train_scene(src)
    port = free_port()

    def client(sock, replies):
        sock.sendall(viewer_message(TRAIN_W, TRAIN_H, keep_alive=False))
        replies.append(viewer_reply(sock, TRAIN_W * TRAIN_H * 3))

    viewer = ViewerClient(port, client)
    model = os.path.join(root, "viewer_model")
    stdout = sys.stdout
    reset_k1()
    t0 = time.perf_counter()
    try:
        state = cli.main(["-s", src, "-m", model, "--iterations", str(TOOLS_CLI_ITERS),
                          "--capacity", str(TRAIN_CAP), "--port", str(port),
                          "--test_iterations", str(TOOLS_CLI_ITERS), "--device", DEV])
        torch.cuda.synchronize()
    finally:
        sys.stdout = stdout
    cli_s = time.perf_counter() - t0
    launches = k1_launches()
    viewer.join()
    (img, verify), = viewer.replies
    metrics = [json.loads(line) for line in open(os.path.join(model, "metrics.jsonl"))]
    steps = [m for m in metrics if "total" in m]
    bad = [(m["iter"], k) for m in metrics for k, v in m.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if (state.step != TOOLS_CLI_ITERS or sum(launches.values()) < TOOLS_CLI_ITERS + 1 or bad or not steps
            or len(img) != TRAIN_W * TRAIN_H * 3 or verify != src):
        raise AssertionError(f"train CLI with --port: step {state.step}, K1 launched "
                             f"{launches}, non-finite {bad}, frame of {len(img)} bytes, "
                             f"verify {verify!r}")

    # a port that is already bound: the warning, then training without a viewer
    buf = io.StringIO()
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        try:
            with contextlib.redirect_stdout(buf):
                busy_state = cli.main(["-s", src, "-m", os.path.join(root, "viewer_busy"),
                                       "--iterations", "2", "--capacity", str(TRAIN_CAP),
                                       "--port", str(busy.getsockname()[1]),
                                       "--device", DEV])
        finally:
            sys.stdout = stdout
    if "[WARN] viewer port unavailable" not in buf.getvalue() or busy_state.step != 2:
        raise AssertionError("a busy --port did not warn and train")
    results["viewer_cli"] = dict(seconds=cli_s, launches=launches, frame_bytes=len(img),
                                 last=steps[-1])
    log(f"[viewer-cli] {TOOLS_CLI_ITERS} iterations with --port {port} in {cli_s:.1f} s: "
        f"one {TRAIN_W}x{TRAIN_H} frame served ({len(img)} bytes), K1 launched {launches} "
        f"times; last {json.dumps(results['viewer_cli']['last'])}; a busy port warned and "
        f"trained 2 iterations")


def run_twin(name: str, argv: list, device: str):
    """``python -m segsplat_tpu_torch.<name>`` in process, with ``--device``;
    returns (its main's result, its stdout, its seconds to a synchronised end)."""
    import importlib

    import torch

    mod = importlib.import_module(f"segsplat_tpu_torch.{name}")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv + ["--device", device])
    torch.cuda.synchronize()
    return out, buf.getvalue(), time.perf_counter() - t


def phase_tool_scripts(results, root: str):
    """(c) The device-side host-script twins at full width on phase 8's
    officescene-scale work dir (512 channels, 876×584 rays, 109 000 voxels),
    each on the card against the CPU, and check_env as a subprocess."""
    import numpy as np
    import torch
    from PIL import Image

    from segsplat_tpu_torch.io.artifacts import save_voxel_features
    from segsplat_tpu_torch.io.ply import read_voxel_grid_ply

    sides = (("card", DEV), ("cpu", "cpu"))
    work = os.path.join(root, "lift")
    if not os.path.exists(os.path.join(work, "grid.ply")):
        from segsplat_tpu_torch import bench
        work = os.path.join(root, "tools_lift")
        write_lift_workdir(work, bench.officescene_lift_scene(n_views=TOOLS_VIEWS))
    grid, lseg, cams = (os.path.join(work, n) for n in ("grid.ply", "lseg", "cameras.json"))
    out = os.path.join(root, "tools")
    os.makedirs(out)
    path = lambda n: os.path.join(out, n)
    report = {}

    # build_sparse_occupancy
    occ = {}
    for side, dev in sides:
        occ[side], _, sec = run_twin("build_sparse_occupancy",
                                     ["--voxel_ply", grid, "--output", path(f"occ_{side}.pt")],
                                     dev)
        report.setdefault("build_sparse_occupancy", {})[f"{side}_s"] = sec
    if not np.array_equal(occ["card"], occ["cpu"]):
        raise AssertionError("build_sparse_occupancy: the card's occupancy differs")
    origin = torch.load(path("occ_card.pt"))["grid_origin"].tolist()
    report["build_sparse_occupancy"]["occupied"] = int((occ["card"] > 0).sum())

    # prepare_tensor_data: two views resized to the 876×584 ray grid
    vs = read_voxel_grid_ply(grid)[2]
    prep = {}
    for side, dev in sides:
        prep[side], _, sec = run_twin("prepare_tensor_data", [
            "--lseg_dir", lseg, "--scaled_camera_params", cams,
            "--occupancy", path("occ_card.pt"), "--voxel_size", str(vs),
            "--grid_origin", *map(str, origin), "--max_images", str(TOOLS_VIEWS),
            "--output", path(f"td_{side}.pt"), "--image_size", str(TRAIN_H), str(TRAIN_W),
            "--downsample_factor", "0.5"], dev)
        report.setdefault("prepare_tensor_data", {})[f"{side}_s"] = sec
    a, b = (prep[side]["encoded_2d_features"] for side in ("card", "cpu"))
    resize_err = float((a - b).abs().max())
    if a.shape != (1, TOOLS_VIEWS, TRAIN_H, TRAIN_W, 512) or resize_err > RESIZE_TOL:
        raise AssertionError(f"prepare_tensor_data: {tuple(a.shape)}, card against CPU "
                             f"{resize_err:.3g}")
    report["prepare_tensor_data"]["resize_max_abs_diff"] = resize_err
    del prep, a, b
    os.remove(path("td_cpu.pt"))

    # project_features, splat and DDA, from the card's tensor data
    for method in ("splat", "dda"):
        proj, secs = {}, {}
        for side, dev in sides:
            proj[side], _, secs[side] = run_twin("project_features", [
                "--tensor_data", path("td_card.pt"), "--method", method,
                "--output", path(f"proj_{method}_{side}.pt")], dev)
        ia, ib = (proj[side]["projected_indices"] for side in ("card", "cpu"))
        fa, fb = (proj[side]["projected_feats"].float() for side in ("card", "cpu"))
        same_idx = ia.shape == ib.shape and torch.equal(ia, ib)
        spacing = torch.as_tensor(np.spacing(np.abs(proj["cpu"]["projected_feats"].numpy())),
                                  dtype=torch.float32)
        within = float(((fa - fb).abs() <= spacing).float().mean()) if same_idx else 0.0
        r = dict(voxels_hit=int(ia.shape[0]), cpu_voxels_hit=int(ib.shape[0]),
                 indices_equal=same_idx, share_within_fp16_spacing=within,
                 feats_max_abs_diff=float((fa - fb).abs().max()) if same_idx else None,
                 card_s=secs["card"], cpu_s=secs["cpu"],
                 views_per_sec=TOOLS_VIEWS / secs["card"])
        report[f"project_features_{method}"] = r
        log(f"[tools] project_features --method {method}: {json.dumps(r)}")
        if not same_idx or within < 1.0:
            raise AssertionError(f"project_features --method {method}: the card parts from "
                                 f"the CPU ({json.dumps(r)})")
    os.remove(path("td_card.pt"))

    # voxeltovoxel_logits on the splat projection's voxels (the query of the
    # single-view chain's output)
    p = torch.load(path("proj_splat_card.pt"))
    xyz = np.ascontiguousarray(p["projected_indices"].numpy()[:, ::-1])
    save_voxel_features(path("vox.pt"), xyz * vs + np.asarray(origin),
                        p["projected_feats"].numpy(), xyz)
    q = {}
    for side, dev in sides:
        q[side], _, sec = run_twin("voxeltovoxel_logits", [
            "--vox", path("vox.pt"), "--prompt", *PIPELINE_PROMPTS,
            "--out", path(f"sem_{side}.npz")], dev)
    la, lb = q["card"]["logits"], q["cpu"]["logits"]
    scale = float(np.abs(lb).max())
    top2 = np.sort(lb, axis=1)
    clear = top2[:, -1] - top2[:, -2] > 1e-3 * scale
    if (not np.allclose(la, lb, rtol=1e-5, atol=1e-5 * scale)
            or not np.array_equal(q["card"]["labels"][clear], q["cpu"]["labels"][clear])):
        raise AssertionError("voxeltovoxel_logits: the card parts from the CPU")
    report["voxeltovoxel_logits"] = dict(
        seconds=sec, voxels=len(la), logits_max_abs_diff=float(np.abs(la - lb).max()),
        labels_equal=int((q["card"]["labels"] == q["cpu"]["labels"]).sum()))

    # aggregate_voxel_colors_onthefly: two seeded images at the cameras' size
    images = path("images")
    os.makedirs(images)
    rng = np.random.default_rng(13)
    with open(cams) as f:
        cam0 = json.load(f)["cameras"]["0"]
    for i in range(TOOLS_VIEWS):
        Image.fromarray(rng.integers(0, 256, (cam0["height"], cam0["width"], 3),
                                     np.uint8)).save(os.path.join(images, f"view_{i:03d}.png"))
    plys = {}
    for side, dev in sides:
        plys[side], _, sec = run_twin("aggregate_voxel_colors_onthefly", [
            "--voxel_ply", grid, "--images_dir", images, "--camera_params", cams,
            "--out_dir", path(f"colors_{side}"), "--max_views", str(TOOLS_VIEWS)], dev)
        report.setdefault("aggregate_voxel_colors_onthefly", {})[f"{side}_s"] = sec
    ca, cb = (read_voxel_grid_ply(plys[side])[1].astype(np.int16) for side in ("card", "cpu"))
    if os.path.basename(plys["card"]) != os.path.basename(plys["cpu"]) or \
            np.abs(ca - cb).max() > 1:
        raise AssertionError(f"aggregate_voxel_colors_onthefly: {plys}, colours up to "
                             f"{np.abs(ca - cb).max()} apart")
    report["aggregate_voxel_colors_onthefly"].update(
        ply=os.path.basename(plys["card"]), colours_max_lsb=int(np.abs(ca - cb).max()))

    # check_env in its own process
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "segsplat_tpu_torch.check_env"],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in r.stdout.splitlines():
        log(f"[check_env] {line}")
    if r.returncode != 0 or not r.stdout.rstrip().endswith("ALL OK"):
        raise AssertionError(f"check_env exited {r.returncode}: {r.stderr[-2000:]}")
    report["check_env_s"] = time.perf_counter() - t
    results["tool_scripts"] = report
    log(f"[tools] {json.dumps(report)}")


def phase_tools(results, root: str):
    """Phase 13: (a) the viewer, (b) the train CLI with --port, (c) the
    device-side host-script twins and check_env."""
    seconds = {}
    for name, fn in (("viewer", lambda: phase_viewer(results)),
                     ("viewer-cli", lambda: phase_viewer_cli(results, root)),
                     ("scripts", lambda: phase_tool_scripts(results, root))):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
    log(f"[tools] parts in s: {json.dumps(seconds)}")


# ──────────── phase 14: the production run at officescene scale ────────────

SCALE_VIEWS = 216               # lifted and rendered: every view of the orbit
SCALE_CPU_LIFT_VIEWS = 2        # the lift's first views, card against the CPU
SCALE_LIFT_RTOL = 1e-5          # their sums: rtol, and an atol of the resize's bound a pixel
SCALE_RESIZE_ULPS = 4           # the resize, card against CPU: ulps of the map's larger side
SCALE_TRACED_VIEWS = 2          # stage 5's per-view loop under torch.profiler
SCALE_WARNINGS = (("lift_overflow", "lift coverage overflow"), ("pair_cap", "> pair_cap"),
                  ("tile_cap", "beyond per-tile K"))
SCALE_ECHOED = 2                # [WARN] lines echoed of each kind; the rest only counted


def dir_bytes(root: str) -> int:
    """Bytes of the files under ``root``, a symlink counted as itself."""
    return sum(os.lstat(os.path.join(d, f)).st_size
               for d, _, files in os.walk(root) for f in files)


def peak_rss_gib() -> float:
    """This process's peak resident set so far (ru_maxrss, KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def echo_run_log(text: str) -> dict:
    """Echo a captured run's lines but its [WARN]s, of which the first
    SCALE_ECHOED of each kind; returns the [WARN] count of each kind."""
    counts = {}
    for line in text.splitlines():
        if "[WARN]" in line:
            kind = next((k for k, part in SCALE_WARNINGS if part in line), "other")
            counts[kind] = counts.get(kind, 0) + 1
            if counts[kind] > SCALE_ECHOED:
                continue
        log(f"[scale] {line}")
    return counts


def phase_scale(results, root: str):
    """Phase 14: (a) officescene_scale_run at FULL, every view lifted and
    rendered, stage by stage; (b) the run held against the plain blend and the
    CPU; (c) stage 5's per-view loop traced; (d) K1 on view 0's inputs."""
    import numpy as np
    import torch

    _tests_on_path()
    from _torch_port import nn_index_mismatch

    from segsplat_tpu_torch import officescene_scale_run as osr
    from segsplat_tpu_torch import render_semantics_logits, run_pipeline
    from segsplat_tpu_torch.io.artifacts import (load_label_map, load_semantics,
                                                 load_voxel_features)
    from segsplat_tpu_torch.io.ply import read_voxel_grid_ply
    from segsplat_tpu_torch.ops.knn import nearest_neighbor_index
    from segsplat_tpu_torch.pipeline.lift_features import (LiftConfig, aggregate_voxel_features,
                                                           resize_features)
    from segsplat_tpu_torch.pipeline.query import query
    from segsplat_tpu_torch.pipeline.render_semantics import render_semantic_views
    from segsplat_tpu_torch.scene import to_device_camera

    dims = osr.FULL
    work = os.path.join(root, "officescene_scale")
    out = dict(disk_free_gb=shutil.disk_usage(root).free / 1e9, dims=dataclasses.asdict(dims))
    stages = {}                 # per stage: peak device memory above the resident, K1 so far
    resident = {}

    def staged(name, fn, first=True, last=True):
        def call(*a, **k):
            if first:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident[name] = torch.cuda.memory_allocated()
            r = fn(*a, **k)
            if last:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - resident[name]
                stages[name] = dict(peak_gib=peak / 2 ** 30,
                                    k1_launches=sum(k1_launches().values()))
            return r
        return call

    swaps = dict(build_voxel_grid=staged("voxel_grid", run_pipeline.build_voxel_grid),
                 aggregate_voxel_features=staged("lift", run_pipeline.aggregate_voxel_features),
                 extract_gaussian_centers=staged("centers_map",
                                                 run_pipeline.extract_gaussian_centers,
                                                 last=False),
                 build_map=staged("centers_map", run_pipeline.build_map, first=False),
                 query=staged("query", run_pipeline.query))
    try:
        # (a) the run, its stdout captured: the [WARN]s counted, not all echoed
        captured = io.StringIO()
        out["host_peak_rss_gib_before"] = peak_rss_gib()
        reset_k1()
        t0 = time.perf_counter()
        try:
            with swapped(run_pipeline, **swaps), \
                    swapped(render_semantics_logits,
                            main=staged("render", render_semantics_logits.main)), \
                    contextlib.redirect_stdout(captured):
                run = osr.run(work, dims, lift_views=SCALE_VIEWS, render_views=SCALE_VIEWS,
                              device=DEV)
                torch.cuda.synchronize()
        finally:
            out["warnings"] = echo_run_log(captured.getvalue())
        out["wall_s"] = time.perf_counter() - t0
        launches = k1_launches()
        results["launches"]["scale"] = launches
        k1_stage5 = stages["render"]["k1_launches"] - stages["query"]["k1_launches"]
        out.update(timing=run["timing"], k1_launches_stage5=k1_stage5, k1_launches=launches,
                   peak_gib={k: v["peak_gib"] for k, v in stages.items()},
                   host_peak_rss_gib=peak_rss_gib())
        if k1_stage5 != SCALE_VIEWS or sum(launches.values()) != SCALE_VIEWS:
            raise AssertionError(f"stage 5 launched K1 {k1_stage5} times ({launches} in the "
                                 f"run) for {SCALE_VIEWS} views")
        model, src = os.path.join(work, "model"), os.path.join(work, "scene")
        out["bytes_written"] = {k: dir_bytes(p) for k, p in (
            ("scene", src), ("features", os.path.join(work, "lseg_features")),
            ("model_ply", os.path.join(model, "point_cloud")), ("pipeline", run["work_dir"]),
            ("render", os.path.join(model, "train")), ("total", work))}
        voxels = int(os.path.basename(run["grid_ply"]).split("_")[1][:-len("vox.ply")])
        hit = int(os.path.basename(run["voxel_features"]).rsplit("_", 1)[1][:-len("vox.pt")])
        out.update(voxels=voxels, voxels_hit=hit,
                   lift_views_per_s=SCALE_VIEWS / run["timing"]["lift"],
                   render_s_per_view=run["timing"]["render"] / SCALE_VIEWS)
        log(f"[scale] (a) {SCALE_VIEWS} views lifted and rendered at "
            f"{dims.render_w}x{dims.render_h}: [TIMING] "
            f"{json.dumps({k: round(v, 3) for k, v in run['timing'].items()})}, "
            f"{out['wall_s']:.1f} s wall; {voxels} voxels, {hit} hit; K1 {k1_stage5} launches "
            f"in stage 5; warnings {json.dumps(out['warnings'])}; peak GiB above the resident "
            f"by stage "
            f"{json.dumps({k: round(v, 3) for k, v in out['peak_gib'].items()})}; host peak RSS "
            f"{out['host_peak_rss_gib']:.2f} GiB ({out['host_peak_rss_gib_before']:.2f} "
            f"before); bytes written {json.dumps(out['bytes_written'])}")

        # (b) every returned artifact reloads; the label maps
        W, H, P = dims.render_w, dims.render_h, len(osr.PROMPTS)   # also the lift's rays
        centers = read_voxel_grid_ply(run["grid_ply"])[0]
        vox = load_voxel_features(run["voxel_features"])
        sem = load_semantics(run["semantics"])
        g2v_path = os.path.join(run["work_dir"], "gauss2voxel.npy")
        mu_path = os.path.join(run["work_dir"], "gaussian_mu.npy")
        g2v, mu = np.load(g2v_path), np.load(mu_path)
        if (len(centers) != voxels or vox["pos"].shape != (hit, 3)
                or vox["feat"].shape != (hit, dims.channels) or mu.shape != (dims.gaussians, 3)
                or g2v.shape != (dims.gaussians,) or g2v.min() < 0 or g2v.max() >= hit
                or sem["logits"].shape != (dims.gaussians, P) or sem["labels"].min() < 0
                or sem["labels"].max() >= P):
            raise AssertionError("the run's artifacts do not reload at their shapes")
        for suffix in ("_gaussians.ply", "_voxels.ply"):
            if not os.path.getsize(run["semantics"].replace(".npz", suffix)):
                raise AssertionError(f"the query wrote an empty {suffix}")
        out_dir = os.path.join(model, "train", "ours_30000", "semantics")
        hist = np.zeros(P, np.int64)
        for i in range(SCALE_VIEWS):
            lab = load_label_map(os.path.join(out_dir, f"{i:05d}_labels.pt"))
            if lab.shape != (H, W) or lab.min() < 0 or lab.max() >= P or not os.path.getsize(
                    os.path.join(out_dir, f"{i:05d}_logits.npy")):
                raise AssertionError(f"view {i}: label map {lab.shape}, labels outside [0, {P}) "
                                     f"or no logits")
            hist += np.bincount(lab.ravel(), minlength=P)
        out["label_share"] = (hist / hist.sum()).round(4).tolist()

        # (b) view 0 against the plain blend
        inputs = view0_blend_inputs(src, model, 30000, run["semantics"])
        out["view0_vs_plain"], out["view0_labels_held"] = view0_against_plain(
            src, model, 30000, run["semantics"], out_dir, inputs)

        # (b) view 0's map resized, and the first views lifted, card against CPU.
        # A bilinear weight comes from a source coordinate in fp32, which the card
        # and the CPU may round apart by up to 2 ulps of the map's larger side an
        # axis, so a resized value may part by SCALE_RESIZE_ULPS such ulps times
        # the map's largest step between neighbours; the lift adds a voxel's
        # pixels in the same order on both, so its sums may part by its count
        # times that
        lseg, cams = os.path.join(work, "lseg_features"), os.path.join(work, "camera_params.json")
        fmap = np.load(os.path.join(lseg, "frame_000.npy"))
        f_card = torch.from_numpy(fmap).to(DEV).float()
        step = max(float(f_card.diff(dim=1).abs().max()), float(f_card.diff(dim=2).abs().max()))
        resize_bound = (SCALE_RESIZE_ULPS * float(np.spacing(np.float32(max(fmap.shape[1:]))))
                        * step)
        resized = resize_features(f_card, H, W).cpu()
        del f_card
        resize_diff = (resized - resize_features(torch.from_numpy(fmap), H, W)).abs()
        out["resize_vs_cpu"] = dict(max_abs_diff=float(resize_diff.max()),
                                    mean_abs_diff=float(resize_diff.mean()), bound=resize_bound)
        del resized, resize_diff
        if out["resize_vs_cpu"]["max_abs_diff"] > resize_bound:
            raise AssertionError(f"view 0's map resized: card against CPU "
                                 f"{json.dumps(out['resize_vs_cpu'])}")
        lifted = {}
        for side, dev in (("card", DEV), ("cpu", "cpu")):
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                r = aggregate_voxel_features(
                    run["grid_ply"], lseg, cams, os.path.join(work, f"lift_{side}"),
                    LiftConfig(max_views=SCALE_CPU_LIFT_VIEWS, view_chunk=4), device=dev)
            lifted[side] = (r["sums"].cpu(), r["counts"].cpu())
            out[f"lift_{SCALE_CPU_LIFT_VIEWS}_{side}_s"] = time.perf_counter() - t
        (s, c), (rs, rc) = lifted["card"], lifted["cpu"]
        diff = (s - rs).abs()
        per_pixel = diff / rc.clamp(min=1)[:, None]
        if not torch.equal(c, rc) or float(
                (diff - SCALE_LIFT_RTOL * rs.abs() - resize_bound * rc[:, None]).max()) > 0:
            raise AssertionError(f"lift of {SCALE_CPU_LIFT_VIEWS} views: counts equal "
                                 f"{torch.equal(c, rc)}, sums up to {float(diff.max()):.3g} "
                                 f"from the CPU's, {float(per_pixel.max()):.3g} a pixel "
                                 f"(resize bound {resize_bound:.3g})")
        out["lift_vs_cpu"] = dict(voxels_hit=int((rc[1:] > 0).sum()),
                                  max_count=int(rc[1:].max()), sums_max_abs_diff=float(diff.max()),
                                  sums_max_abs=float(rs.abs().max()),
                                  max_diff_per_pixel=float(per_pixel.max()))
        del lifted, s, rs, diff, per_pixel

        # (b) the 1-NN map on a sample, and the query, against the CPU
        sub = np.random.default_rng(12).choice(dims.gaussians, NN_SUBSET, replace=False)
        cpu_idx = nearest_neighbor_index(torch.from_numpy(mu[sub]),
                                         torch.from_numpy(vox["pos"].astype(np.float32))).numpy()
        differ, gap = nn_index_mismatch(mu[sub], vox["pos"], g2v[sub], cpu_idx)
        out["nn_vs_cpu"] = dict(sample=NN_SUBSET, equal_share=1.0 - differ / NN_SUBSET,
                                max_gap=gap)
        with contextlib.redirect_stdout(io.StringIO()):
            cpu_q = query(run["voxel_features"], g2v_path, mu_path, osr.PROMPTS,
                          os.path.join(work, "semantics_cpu.npz"), save_ply=False, device="cpu")
        out["query_logits_vs_cpu"] = check_logits("scale query", sem["logits"], sem["labels"],
                                                  cpu_q["logits"], cpu_q["labels"])
        log(f"[scale] (b) artifacts reload; {SCALE_VIEWS} label maps [{H}, {W}] in [0, {P}), "
            f"shares {out['label_share']}; view 0 logits vs plain max abs diff "
            f"{out['view0_vs_plain']:.3g} (fp16 file), labels equal on "
            f"{out['view0_labels_held']} px with top1-top2 > 1e-2; view 0's map resized "
            f"card vs CPU {json.dumps(out['resize_vs_cpu'])}; lift of "
            f"{SCALE_CPU_LIFT_VIEWS} views card vs CPU {json.dumps(out['lift_vs_cpu'])} "
            f"(card {out[f'lift_{SCALE_CPU_LIFT_VIEWS}_card_s']:.1f} s, CPU "
            f"{out[f'lift_{SCALE_CPU_LIFT_VIEWS}_cpu_s']:.1f} s); 1-NN "
            f"{json.dumps(out['nn_vs_cpu'])}; query logits vs CPU "
            f"{out['query_logits_vs_cpu']:.3g}, labels equal beyond a {LABEL_GAP} top-2 gap")

        # (c) stage 5's per-view loop (render, then the view's files), traced
        scene, logits, cam, bi, bg, K, _ = inputs
        table = scene.gaussians
        logits_np = logits.cpu().numpy()
        traced = [to_device_camera(c, 1.0, device=DEV)
                  for c in scene.get_train_cameras()[:SCALE_TRACED_VIEWS]]
        trace_dir = os.path.join(work, "traced")

        def view(v):
            render_semantic_views(table, [traced[v]], logits_np, trace_dir, prompts=osr.PROMPTS)

        with contextlib.redirect_stdout(io.StringIO()):
            view(0)
            out["trace"] = device_trace(view, SCALE_TRACED_VIEWS, share_of="blend_fwd_kernel")
        log(f"[scale] (c) stage 5's loop, {SCALE_TRACED_VIEWS} views traced: "
            + json.dumps(out["trace"]))

        # (d) K1 on view 0's inputs, at the 32 channels stage 5 blends
        out.update(num_pairs=int(bi.num_pairs), tile_overflow=int(bi.tile_overflow))
        out["k1"] = k1_on_inputs(results, (bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n,
                                           K), "scale", f"{cam.width}x{cam.height}")
        del scene, table, logits, inputs, bi, bg
        results["scale"] = out
    finally:
        shutil.rmtree(work, ignore_errors=True)       # ~2.9 GB of logits alone
        torch.cuda.empty_cache()
    log(f"[scale] view 0: {out['num_pairs']} pairs, {out['tile_overflow']} past K = 256; "
        f"the work dir removed")


# ─────────────────────── phase 15: the measurement programs ───────────────────────

MEASURE_MODULES = ("segsplat_tpu_torch.bench", "segsplat_tpu_torch.perf_raster_stages",
                   "segsplat_tpu_torch.perf_bin_dissect", "segsplat_tpu_torch.perf_lift_stages",
                   "segsplat_tpu_torch.perf_train")
MEASURE_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "segsplat_tpu", "scripts", "tests")
MEASURE_TIMEOUT = 600
BENCH_KEYS = ({"metric", "value", "unit", "vs_baseline", "extra"},          # bench.py's line,
              {"lift_views_per_s", "lift_config", "hostile_render"},        # less its two
              {"fps", "config", "max_pairs_per_frame", "tile_overflow_max"})  # lift_baseline keys
RASTER_LINES = ("full rasterize", "project", "project + bin", "depth argsort", "pair-key sort",
                "gather#1", "gather#2", "blend kernel")
LIFT_LINES = ("resize CHW", "resize + transpose", "transpose(half)", "splat first-hit",
              "scatter segment_sum", "FULL view")
RASTER_FRAMES = 16          # perf_raster_stages' default --frames

# The child process: JAX, the JAX package, scripts/ and tests/ cannot be
# imported (as in tests/test_torch_no_jax.py); each program runs as ``python -m``
# runs it, its counts set to 0 just before and read just after.
MEASURE_CHILD = """
import contextlib, io, json, runpy, sys, time
blocked = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in blocked:
        sys.modules[name] = None
for name in blocked:
    sys.modules[name] = None
from segsplat_tpu_torch.ops import blend as B
from segsplat_tpu_torch.ops import rasterize as R
for mod in {modules!r}:
    B.blend_tiles.launches = B.blend_tiles_bwd.launches = B.blend_tiles_packed.launches = 0
    B.blend_tiles_indexed.launches = R.project_gaussians.launches = 0
    R.project_gaussians.backward_launches = 0
    sys.argv = [mod]
    out = io.StringIO()
    t0 = time.perf_counter()
    done = False
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(mod, run_name="__main__", alter_sys=True)
        done = True
    finally:
        if not done:
            print(mod + " failed after printing:", out.getvalue(), sep="\\n", file=sys.stderr)
    launches = dict(blend_fwd=B.blend_tiles.launches,
                    blend_fwd_indexed=B.blend_tiles_indexed.launches,
                    blend_bwd=B.blend_tiles_bwd.launches, blend_packed=B.blend_tiles_packed.launches)
    print(json.dumps(dict(module=mod, seconds=time.perf_counter() - t0, stdout=out.getvalue(),
                          launches=launches, project_launches=R.project_gaussians.launches,
                          project_bwd_launches=R.project_gaussians.backward_launches)),
          flush=True)
"""


def timed_lines(stdout: str, prefixes, closing: str = "") -> dict:
    """{name: ms} of a scoreboard's lines ``<name> <ms> ms/<frame|view|step>``,
    in order; raises unless the i-th starts with ``prefixes[i]`` and a line
    starts with ``closing``."""
    import re

    found = [m.groups() for m in (re.match(r"^(.*?)\s+([-\d.]+) ms/(?:frame|view|step)\b", line)
                                  for line in stdout.splitlines()) if m]
    if (len(found) != len(prefixes)
            or not all(n.startswith(p) for (n, _), p in zip(found, prefixes))
            or not any(line.startswith(closing) for line in stdout.splitlines())):
        raise AssertionError(f"want lines {prefixes} and {closing!r}, got:\n{stdout}")
    return {n.strip(): float(ms) for n, ms in found}


def hostile_pairs_recount(frames: int, sets: int) -> list:
    """The hostile scene's real pair count on each camera of the bench's sets
    (bench.view_sets), each read on the host at once: the bench's device-side
    maximum is held to these."""
    import torch

    from segsplat_tpu_torch import bench
    from segsplat_tpu_torch.ops.rasterize import bin_gaussian_ranks, project_gaussians

    sc = bench.hostile_render_scene()
    t = bench.scene_tensors(sc, DEV)
    cam = bench_camera(FRAME_W, FRAME_H)[1:]
    counts = []
    for vm in (v for vms in bench.view_sets(sc, 0.003, frames, sets, DEV) for v in vms):
        proj = project_gaussians(t["xyz"], t["scales"], t["quats"], vm, *cam, FRAME_W, FRAME_H)
        _, _, offsets, _ = bin_gaussian_ranks(proj, FRAME_W, FRAME_H,
                                              sc["kw"]["max_tiles_per_axis"])
        counts.append(int(offsets[-1]))
    del t
    torch.cuda.empty_cache()
    return counts


def phase_measure(results):
    """Phase 15: the bench and the four scoreboards, each as ``python -m`` runs it
    at its defaults, in one child process that cannot import JAX or the JAX
    package; their lines checked, their kernel launches counted."""
    import torch

    from segsplat_tpu_torch import bench, perf_train

    torch.cuda.empty_cache()
    code = MEASURE_CHILD.format(blocked=MEASURE_BLOCKED, modules=MEASURE_MODULES)
    r = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=MEASURE_TIMEOUT)
    if r.returncode != 0:
        raise AssertionError(f"the measurement programs failed (exit {r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    runs = {}
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            runs[rec["module"].rsplit(".", 1)[1]] = rec
    if set(runs) != {m.rsplit(".", 1)[1] for m in MEASURE_MODULES}:
        raise AssertionError(f"programs that reported: {sorted(runs)}")
    for name, rec in runs.items():
        for text in rec["stdout"].rstrip().splitlines():
            log(f"[measure] {name}: {text}")
        log(f"[measure] {name}: {rec['seconds']:.1f} s, launches {json.dumps(rec['launches'])}, "
            f"projection kernels {rec['project_launches']} forward, "
            f"{rec['project_bwd_launches']} backward")

    # the bench: bench.py's keys, K1 once a frame rendered, the pair maximum
    b = runs["bench"]
    line = json.loads(b["stdout"].strip().splitlines()[-1])
    keys = (set(line), set(line["extra"]), set(line["extra"]["hostile_render"]))
    if keys != BENCH_KEYS:
        raise AssertionError(f"the bench's line has keys {keys}, not {BENCH_KEYS}")
    frames = (bench.SETS + 1) * (bench.FRAMES + bench.HOSTILE_FRAMES)
    if b["launches"] != dict(blend_fwd=0, blend_fwd_indexed=frames, blend_bwd=0,
                             blend_packed=0):
        raise AssertionError(f"the bench rendered {frames} frames and launched {b['launches']}")
    if b["project_launches"] != frames:
        raise AssertionError(f"the bench rendered {frames} frames and launched the projection "
                             f"kernel {b['project_launches']} times")
    if not (line["value"] > 0 and line["extra"]["lift_views_per_s"] > 0
            and line["extra"]["hostile_render"]["fps"] > 0):
        raise AssertionError(f"the bench's line: {line}")
    recount = hostile_pairs_recount(bench.HOSTILE_FRAMES, bench.SETS)
    hostile = line["extra"]["hostile_render"]
    if hostile["max_pairs_per_frame"] != max(recount):
        raise AssertionError(f"the bench's largest hostile pair count "
                             f"{hostile['max_pairs_per_frame']} is not the recount's "
                             f"{max(recount)}")
    phase3 = results["scenes"].get("hostile", {}).get("num_pairs")
    if phase3 is not None and recount[0] != phase3:
        raise AssertionError(f"the bench's hostile frame 0 has {recount[0]} pairs, phase 3's "
                             f"frame {phase3}")

    # the scoreboards: every line, K1 and K2 where their paths run them
    raster = timed_lines(runs["perf_raster_stages"]["stdout"], RASTER_LINES, "accounted")
    bins = timed_lines(runs["perf_bin_dissect"]["stdout"], [f"stage {s}:" for s in range(8)],
                       "real pairs")
    lift = timed_lines(runs["perf_lift_stages"]["stdout"], LIFT_LINES)
    train_line = timed_lines(runs["perf_train"]["stdout"], ("train step",))
    steps = (perf_train.REPS + 1) * (perf_train.F1 + perf_train.F2)
    # perf_raster_stages: its full rasterize (no grad) on the indexed variant,
    # K1 alone on the gathered payload; 4 passes of the frames each
    want = {"perf_raster_stages": dict(blend_fwd=4 * RASTER_FRAMES,
                                       blend_fwd_indexed=4 * RASTER_FRAMES, blend_bwd=0,
                                       blend_packed=0),
            "perf_bin_dissect": dict(blend_fwd=0, blend_fwd_indexed=0, blend_bwd=0,
                                     blend_packed=0),
            "perf_lift_stages": dict(blend_fwd=0, blend_fwd_indexed=0, blend_bwd=0,
                                     blend_packed=0),
            "perf_train": dict(blend_fwd=steps, blend_fwd_indexed=0, blend_bwd=steps,
                               blend_packed=0)}
    for name, counts in want.items():
        if runs[name]["launches"] != counts:
            raise AssertionError(f"{name} launched {runs[name]['launches']}, not {counts}")
    # the projection's kernels: a forward a frame or step, a backward a step
    proj = {name: (rec["project_launches"], rec["project_bwd_launches"])
            for name, rec in runs.items()}
    if proj["perf_train"] != (steps, steps) or proj["bench"][1] or proj["perf_raster_stages"][1]:
        raise AssertionError(f"projection kernel launches (forward, backward) {proj}; "
                             f"perf_train took {steps} steps")
    results["measure"] = dict(
        bench=line, hostile_recount=dict(max=max(recount), frame0=recount[0], phase3=phase3),
        raster=raster, bin_dissect=bins, lift=lift, train=train_line,
        launches={k: v["launches"] for k, v in runs.items()},
        project_launches=proj,
        seconds={k: v["seconds"] for k, v in runs.items()})
    log("[measure] " + json.dumps(results["measure"]))


# ──────────────── phase 16: the compiled frame and the harness programs ────────────────

COMPILE_LABEL_AGREE = 0.9999    # the compiled 1080p frame's argmax labels against eager
COMPILE_TIMED = 5               # compiled and eager frames, CUDA events, median
HARNESS_TIMEOUT = 900
HARNESS_OK = ("entry ok:", "dryrun_multichip ok:", "dryrun_multichip lift ok:",
              "dryrun_multichip render ok:")
GUARD_COUNTS = ("flops", "bytes_accessed", "temp_bytes", "nodes")
PARITY_VIEWS = 8                # label maps a variant, at the reference's 584×876


def recording(real, key: str, rec: dict):
    """``real`` (a blend wrapper) that keeps its last arguments and result in
    ``rec[key]``. A wrapper adds to the ``launches`` of the module name it runs
    under, so the recorder swapped in under that name carries its own count."""
    def wrapper(*args):
        out = real(*args)
        rec[key] = (args, out)
        return out

    wrapper.launches = 0
    return wrapper


def compile_entry(results) -> tuple:
    """(a) ``graft_entry.entry()``'s frame through Inductor (fullgraph), with
    its logits requiring grad: against eager within 1e-4 and K1 once a call;
    one backward through it, K2 once, d_payload and the logits' gradient
    against eager's at rtol 5e-3, atol 2e-4·max|ref|. Returns (stats, the
    compiled backward's K2 arguments)."""
    import torch

    from segsplat_tpu_torch import graft_entry
    from segsplat_tpu_torch.ops import blend as B

    fn, (table, cam, logits, bg) = graft_entry.entry()
    compiled = torch.compile(fn, fullgraph=True)
    gen = torch.Generator(DEV).manual_seed(16)
    runs = {}
    for name, f in (("eager", fn), ("compiled", compiled), ("compiled again", compiled)):
        rec = {}
        fwd, bwd = recording(B.blend_tiles, "fwd", rec), recording(B.blend_tiles_bwd, "bwd", rec)
        lg = logits.detach().clone().requires_grad_(True)
        t0 = time.perf_counter()
        with swapped(B, blend_tiles=fwd, blend_tiles_bwd=bwd):
            out = f(table, cam, lg, bg)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            if name == "eager":
                w = [torch.randn(o.shape, generator=gen, device=DEV) for o in out[:2]]
            ((out[0] * w[0]).sum() + (out[1] * w[1]).sum()).backward()
            torch.cuda.synchronize()
        runs[name] = dict(out=[o.detach() for o in out], rec=rec, grad=lg.grad, k1=fwd.launches,
                          k2=bwd.launches, forward_s=fwd_s, seconds=time.perf_counter() - t0)
    e, c = runs["eager"], runs["compiled again"]
    for name in ("compiled", "compiled again"):
        if (runs[name]["k1"], runs[name]["k2"]) != (1, 1):
            raise AssertionError(f"{name}: the forward and backward launched K1 "
                                 f"{runs[name]['k1']}, K2 {runs[name]['k2']} times")
    err = max(compare(f"compiled entry {name}", [g], [r])
              for name, g, r in zip(("render", "semantic_logits"), c["out"], e["out"]))
    if not torch.equal(c["out"][2], e["out"][2]):
        raise AssertionError("the compiled entry's radii differ from eager's")
    (bargs, (d_pay, d_bg)), (eargs, (e_pay, e_bg)) = c["rec"]["bwd"], e["rec"]["bwd"]
    if not torch.equal(bargs[0], eargs[0]):
        raise AssertionError("the compiled frame's tile offsets differ from eager's")
    grad_err = max(compare_grad("compiled entry K2 d_payload", d_pay.detach(), e_pay.detach()),
                   compare_grad("compiled entry K2 d_bg", d_bg.detach(), e_bg.detach()),
                   compare_grad("compiled entry d logits", c["grad"], e["grad"]))
    stats = dict(compile_s=runs["compiled"]["forward_s"],
                 backward_compile_s=runs["compiled"]["seconds"] - runs["compiled"]["forward_s"],
                 max_abs_err=err, grad_max_abs_err=grad_err, k1_launches=c["k1"],
                 k2_launches=c["k2"], ch=int(bargs[2].shape[0]))
    log("[compile] entry: " + json.dumps(stats))
    return stats, bargs


def compile_frames() -> dict:
    """(b) the 1080p headline frame (200 000 Gaussians, 32 channels, m = 3,
    K = 256) through Inductor: eager against compiled (max |Δ|, argmax labels
    equal on ≥ 99.99 % of pixels, both pair counts), K1 once a call, and
    compile seconds. Returns {"headline": (stats, a function that times the
    compiled and the eager frame)}."""
    import torch

    from segsplat_tpu_torch import bench
    from segsplat_tpu_torch.ops import blend as B
    from segsplat_tpu_torch.ops import rasterize as Rz

    W, H = FRAME_W, FRAME_H
    sc = bench_scene("headline")
    m, K, cap = sc["m"], sc["K"], sc["pair_cap"]
    vm, fx, fy, cx, cy = bench_camera(W, H)
    t = bench.scene_tensors(sc, DEV)
    args = (t["xyz"], t["scales"], t["quats"], t["opac"], t["logits"],
            torch.as_tensor(vm, device=DEV))
    bg = torch.zeros(32, device=DEV)

    def frame(xyz, scales, quats, opac, logits, vm):
        out = Rz.rasterize(xyz, scales, quats, opac, logits, vm, fx, fy, cx, cy, W, H, bg=bg,
                           max_tiles_per_axis=m, max_per_tile=K, pair_cap=cap)
        return out["image"], out["num_pairs"], out["tile_overflow"]

    with torch.no_grad():
        compiled = torch.compile(frame, fullgraph=True)
        t0 = time.perf_counter()
        got = compiled(*args)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        ref = frame(*args)
        B.blend_tiles.launches = 0
        got = compiled(*args)
        torch.cuda.synchronize()
        launches = B.blend_tiles.launches
        if launches != 1:
            raise AssertionError(f"the compiled headline frame launched blend_tiles "
                                 f"{launches} times")
        agree = float((got[0].argmax(-1) == ref[0].argmax(-1)).float().mean())
        s = dict(compile_s=compile_s, launches=launches,
                 max_abs_diff=float((got[0] - ref[0]).abs().max()), label_agree=agree,
                 num_pairs=int(got[1]), eager_num_pairs=int(ref[1]),
                 tile_overflow=int(got[2]), eager_tile_overflow=int(ref[2]))
        del got, ref
    log("[compile] headline: " + json.dumps(s))
    if agree < COMPILE_LABEL_AGREE:
        raise AssertionError(f"the compiled headline frame's labels agree with eager's on "
                             f"{agree:.6f} of the pixels, under {COMPILE_LABEL_AGREE}")

    def timed():
        with torch.no_grad():
            s["compiled_ms"] = cuda_time_ms(lambda: compiled(*args), reps=COMPILE_TIMED)
            s["eager_ms"] = cuda_time_ms(lambda: frame(*args), reps=COMPILE_TIMED)
        return s

    return {"headline": (s, timed)}


@contextlib.contextmanager
def children(root: str, commands: dict):
    """Start ``python ARGV...`` for each {name: argv} from the repo's root,
    their output into files under ``root``; yields a function that waits for
    one by name and returns its stdout (raising when it exits non-zero or
    outlasts HARNESS_TIMEOUT). Kills every child still running on exit."""
    procs = {}
    for name, argv in commands.items():
        out = open(os.path.join(root, f"{name}.out"), "w+")
        err = open(os.path.join(root, f"{name}.err"), "w+")
        procs[name] = (subprocess.Popen([sys.executable, *argv], stdout=out, stderr=err,
                                        text=True,
                                        cwd=os.path.dirname(os.path.abspath(__file__))),
                       out, err, time.perf_counter())

    def wait(name: str) -> str:
        p, out, err, t0 = procs[name]
        p.wait(timeout=max(HARNESS_TIMEOUT - (time.perf_counter() - t0), 1.0))
        out.seek(0)
        err.seek(0)
        text = out.read()
        if p.returncode != 0:
            raise AssertionError(f"{name} exited {p.returncode}:\n{text[-3000:]}\n"
                                 f"{err.read()[-3000:]}")
        log(f"[harness] {name}: {time.perf_counter() - t0:.1f} s")
        return text

    try:
        yield wait
    finally:
        for p, out, err, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()


def guard_rows(text: str) -> dict:
    """perf_guard's printed line, its three programs' rows."""
    line = json.loads(text.strip().splitlines()[-1])
    rows = {k: v for k, v in line.items() if isinstance(v, dict)}
    if len(rows) != 3:
        raise AssertionError(f"perf_guard's programs: {sorted(rows)}")
    return rows


def phase_compile(results, root: str):
    """Phase 16. (c) ``python -m segsplat_tpu_torch.graft_entry`` (its ok lines)
    and the CPU half of (d), ``python -m segsplat_tpu_torch.perf_guard --device
    cpu --no-walltime``, run as children while this process compiles (a) and
    (b); then, with the host quiet, the frame and K1/K2 on the compiled entry's
    inputs are timed, and (d)'s card half runs alone: its counts must equal the
    CPU's. (e) ``parity_real`` on seeded label maps at 584×876, 3 variants of
    8 views. Prints phase 15's bench line."""
    _tests_on_path()
    from _torch_port import write_label_maps

    from segsplat_tpu_torch import parity_real

    t_phase = time.perf_counter()
    with children(root, {"graft_entry": ["-m", "segsplat_tpu_torch.graft_entry"],
                         "perf_guard_cpu": ["-m", "segsplat_tpu_torch.perf_guard", "--device",
                                            "cpu", "--no-walltime"]}) as wait:
        entry, bargs = compile_entry(results)
        frames = compile_frames()
        compiles_s = time.perf_counter() - t_phase
        texts = {name: wait(name) for name in ("graft_entry", "perf_guard_cpu")}
    for line in texts["graft_entry"].splitlines():
        log(f"[harness] graft_entry: {line}")
    ok = {p: [line for line in texts["graft_entry"].splitlines() if line.startswith(p)]
          for p in HARNESS_OK}
    if not all(len(lines) == 1 for lines in ok.values()):
        raise AssertionError(f"graft_entry's ok lines: {ok}")

    offsets, payload, bgw, img, alpha, g_img, g_alpha, tx_n, ty_n, K = bargs
    entry["fwd"], entry["bwd"] = kernels_on_inputs(
        results, (offsets, payload, bgw, tx_n, ty_n, K), img, alpha, g_img, g_alpha,
        "compile", "64x64")
    for name, (s, timed) in frames.items():
        s = timed()
        s["phase3_rasterize_ms"] = results["scenes"].get("headline", {}).get("rasterize_ms")
        log(f"[compile] {name} timed: compiled {s['compiled_ms']:.3f} ms, eager "
            f"{s['eager_ms']:.3f} ms (phase 3's rasterize: {s['phase3_rasterize_ms']})")

    t0 = time.perf_counter()
    with children(root, {"perf_guard_cuda": ["-m", "segsplat_tpu_torch.perf_guard"]}) as wait:
        card_text = wait("perf_guard_cuda")
    guard = {"cpu": guard_rows(texts["perf_guard_cpu"]), "cuda": guard_rows(card_text)}
    for name, card in guard["cuda"].items():
        cpu = guard["cpu"][name]
        log(f"[harness] perf_guard {name}: " + json.dumps(
            {k: v for k, v in card.items() if k != "nodes"}) + f"; {sum(card['nodes'].values())} "
            f"nodes, {card['nodes'].get('segsplat_torch.blend_fwd.default', 0)} K1; the CPU's "
            f"export {cpu['export_s']:.1f} s")
        differ = [k for k in GUARD_COUNTS if cpu.get(k) != card.get(k)]
        if differ:
            raise AssertionError(f"perf_guard {name}: {differ} differ between the CPU and "
                                 f"the card")
    guard_s = time.perf_counter() - t0

    ref_root = os.path.join(root, "parity_real")
    write_label_maps(ref_root, PARITY_VIEWS, *parity_real.REFERENCE_SHAPE)
    report = os.path.join(root, "parity_real.md")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        parity_real.main(["--ref_root", ref_root, "--out", report])
    parity_s = time.perf_counter() - t0
    with open(report) as f:
        lines = f.read().splitlines()
    exact = [line for line in lines if f"{PARITY_VIEWS}/{PARITY_VIEWS} sampled files "
             "round-tripped EXACT" in line]
    pairs = [line for line in lines if " vs " in line and line.startswith("|")]
    for line in printed.getvalue().splitlines():
        log(f"[harness] parity_real: {line}")
    if len(exact) != 3 or len(pairs) != 3:
        raise AssertionError("parity_real's report:\n" + "\n".join(lines))

    log(f"[compile] (a), (b) and the children {compiles_s:.1f} s, the card's perf_guard "
        f"{guard_s:.1f} s, parity_real {parity_s:.1f} s")
    results["compile"] = dict(
        entry=entry, frames={k: s for k, (s, _) in frames.items()}, compiles_s=compiles_s,
        perf_guard_s=guard_s, parity_real_s=parity_s, parity_pairs=pairs,
        perf_guard={d: {k: {kk: vv for kk, vv in v.items() if kk != "nodes"}
                        for k, v in g.items()} for d, g in guard.items()})
    bench_line = results.get("measure", {}).get("bench")
    log("[compile] the bench's line (phase 15): "
        + (json.dumps(bench_line) if bench_line else "not measured: phase 15 did not run"))

LIST_KEYS = ("warp_rows_read", "warp_rows_kept", "warp_rows_hit", "kept_share", "hit_share")


def kernel_entry(name, ch, source, replaces, launches, max_abs_err, t, **extra):
    """One kernel's entry of the ``{"kernels": [...]}`` line; K1's and K3's
    carry their row lists' shares from ``t``."""
    return dict(name=name, ch=ch, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None, **{k: t[k] for k in LIST_KEYS if k in t}, **extra)


PHASES = ("small", "full", "main", "train", "train-cli", "logits", "other-blends", "lift",
          "query", "slic", "loop", "mesh", "edit", "multi", "tools", "scale", "measure",
          "compile")
PSEUDO_LABEL_PHASES = ("slic", "loop", "mesh")      # phase 10 (b)-(e)


def main(argv=None) -> int:
    import argparse

    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--train-child"]:         # a rank process of phase 12c's torchrun
        return train_child(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (all by default); the kernels "
                         "line and the final line are printed only for all of them")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from segsplat_tpu_torch.utils import cuda_build

    t_all = time.perf_counter()
    # torch.compile's caches (phase 16) in the checkout's build/, for this
    # process and its children
    compile_cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "torch_compile")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(compile_cache, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(compile_cache, "triton"))
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

    from segsplat_tpu_torch.ops.blend import (KERNEL_WIDTHS, PACKED_WIDTHS,
                                              blend_forward_occupancy,
                                              blend_tiles_bwd_occupancy)

    k2_occupancy = {}
    for ch in KERNEL_WIDTHS:
        blocks, smem = blend_tiles_bwd_occupancy(ch)
        k2_occupancy[ch] = dict(blocks_per_sm=blocks, smem_bytes=smem)
    log(f"[occupancy] blend_bwd: {json.dumps(k2_occupancy)}")
    occupancy = {k: {ch: blend_forward_occupancy(k, ch) for ch in widths}
                 for k, widths in (("blend_fwd", KERNEL_WIDTHS),
                                   ("blend_packed", PACKED_WIDTHS))}
    occupancy["blend_fwd_indexed"] = {ch: blend_forward_occupancy("blend_fwd", ch, "_indexed")
                                      for ch in KERNEL_WIDTHS}
    log(f"[occupancy] {json.dumps(occupancy)}")

    results = {"fwd_err": 0.0, "bwd_err": 0.0, "scenes": {},
               "launches": {}, "packed": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    run = {"small": lambda: phase_card_tests(root),
           "full": lambda: phase_full(results),
           "main": lambda: phase_main_path(results, root),
           "train": lambda: phase_train_step(results),
           "train-cli": lambda: phase_train_cli(results, root),
           "logits": lambda: phase_logits_render(results),
           "other-blends": lambda: phase_other_blends(results),
           "lift": lambda: phase_lift(results, root),
           "query": lambda: phase_query(results, root),
           "slic": lambda: phase_slic(results),
           "loop": lambda: phase_loop(results, root),
           "mesh": lambda: phase_mesh(results, root),
           "edit": lambda: phase_edit(results, root),
           "multi": lambda: phase_multi(results, root),
           "tools": lambda: phase_tools(results, root),
           "scale": lambda: phase_scale(results, root),
           "measure": lambda: phase_measure(results),
           "compile": lambda: phase_compile(results, root)}
    seconds = {}
    try:
        for name in phases:
            t0 = time.perf_counter()
            run[name]()
            seconds[name] = time.perf_counter() - t0
            log(f"[{name}] done in {seconds[name]:.1f} s")
        log(f"[pseudo-labels] phase 10 in "
            f"{sum(seconds.get(p, 0.0) for p in PSEUDO_LABEL_PHASES):.1f} s")
        log(f"[edit] phase 11 in {seconds.get('edit', 0.0):.1f} s")
        log(f"[multi] phase 12 in {seconds.get('multi', 0.0):.1f} s")
        log(f"[tools] phase 13 in {seconds.get('tools', 0.0):.1f} s")
        log(f"[scale] phase 14 in {seconds.get('scale', 0.0):.1f} s")
        log(f"[measure] phase 15 in {seconds.get('measure', 0.0):.1f} s")
        log(f"[compile] phase 16 in {seconds.get('compile', 0.0):.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if set(phases) != set(PHASES):
        log(f"[total] {time.perf_counter() - t_all:.1f} s for phases {phases} on {smi}; "
            "no result line: not every phase ran")
        return 2

    fwd_src, bwd_src, packed_src, project_src = (f"segsplat_tpu_torch/csrc/{k}.cu"
                                                 for k in KERNELS)
    k1_tpu, k2_tpu = ("segsplat_tpu/ops/blend_pallas.py:188",
                      "segsplat_tpu/ops/blend_pallas_vjp.py:195")
    k3_tpu = "segsplat_tpu/ops/blend_pallas2.py:141"
    train_launches = results["launches"]["train"]
    logits, packed = results["logits_render"], results["packed"]
    headline = results["scenes"]["headline"]
    k1_cli, k1_pipe = results["launches"]["render_semantics"], results["launches"]["pipeline"]
    measure = results["measure"]
    launches = measure["launches"]
    k3_by_path = {"render_semantics": k1_cli["blend_packed"],
                  "run_pipeline stage 5": k1_pipe["blend_packed"],
                  **{name: c["blend_packed"] for name, c in launches.items()}}
    k3_program = k1_cli["blend_packed"] + k1_pipe["blend_packed"]
    if any(k3_by_path.values()):
        raise AssertionError(f"a program path launched K3: {k3_by_path}")
    kernels = [
        # the kernel every no-grad render on the card runs; its launches are the
        # render CLI's and stage 5's own, their counters set to 0 just before
        kernel_entry("blend_fwd_indexed", 32, fwd_src, k1_tpu,
                     k1_cli["blend_fwd_indexed"] + k1_pipe["blend_fwd_indexed"],
                     max(headline["indexed"]["max_abs_err"],
                         results["scenes"]["hostile"]["indexed"]["max_abs_err"],
                         results["main_indexed"]["max_abs_err"]),
                     headline["indexed"],
                     path="render_semantics CLI + run_pipeline stage 5 (no grad); times on "
                          "phase 3's headline frame",
                     launches_by_path={
                         "render_semantics": k1_cli["blend_fwd_indexed"],
                         "run_pipeline stage 5": k1_pipe["blend_fwd_indexed"],
                         "bench": launches["bench"]["blend_fwd_indexed"],
                         "perf_raster_stages": launches["perf_raster_stages"]["blend_fwd_indexed"],
                         f"rasterize_sharded strips, {STRIP_W}x{STRIP_H}":
                             results["multi_strips"]["launches"]["blend_fwd_indexed"],
                         "officescene_scale_run": results["launches"]["scale"]["blend_fwd_indexed"]},
                     hostile=results["scenes"]["hostile"]["indexed"],
                     render_cli_view0=results["main_indexed"],
                     **occupancy["blend_fwd_indexed"][32]),
        kernel_entry("blend_fwd", 32, fwd_src, k1_tpu,
                     k1_cli["blend_fwd"] + k1_pipe["blend_fwd"],
                     headline["max_abs_err"], headline,
                     path="render_semantics CLI + run_pipeline stage 5 (their renders need no "
                          "grad, so they launch blend_fwd_indexed); times on the gathered payload",
                     launches_by_path={"render_semantics": k1_cli["blend_fwd"],
                                       "run_pipeline stage 5": k1_pipe["blend_fwd"]},
                     scenes=results["scenes"],
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
        # no program path runs K3 (the render CLI, stage 5 and the measure
        # child's runs each check its counter at 0): phase 7 (b) launches it on
        # payloads it packs
        kernel_entry("blend_packed", 32, packed_src, k3_tpu, k3_program,
                     max(packed["headline"]["max_abs_err"], packed["hostile"]["max_abs_err"]),
                     packed["headline"], path="render_semantics CLI + run_pipeline stage 5; "
                                              "times on phase 7 (b)'s packed payload of the "
                                              "headline frame",
                     launches_by_path=k3_by_path,
                     hostile=packed["hostile"], **occupancy["blend_packed"][32]),
        kernel_entry("blend_packed", 51, packed_src, k3_tpu, k3_program,
                     packed["logits51"]["max_abs_err"], packed["logits51"],
                     path="render_semantics CLI + run_pipeline stage 5; times on phase 7 (b)'s "
                          "packed payload of the render(semantic_logits) frame",
                     launches_by_path=k3_by_path, **occupancy["blend_packed"][51]),
    ]
    slic, loop = results["slic"], results["loop"]
    for key, label in (("sweep20", "hard scene, 20 objects"), ("sweep5", "5 objects")):
        sw = slic[key]
        width = sw["fwd"]["kernel_width"]
        kernels.append(kernel_entry(
            "blend_fwd", sw["ch"], fwd_src, k1_tpu, sw["launches"]["blend_fwd"],
            sw["fwd"]["max_abs_err"], sw["fwd"],
            path=f"pseudo_label_loop GT sweep, {label}, {SLIC_W}x{SLIC_H}",
            indexed_launches=sw["launches"]["blend_fwd_indexed"],
            kernel_width=width, k2_same_inputs=sw["bwd"], **occupancy["blend_fwd"][width]))
    kernels.append(kernel_entry(
        "blend_fwd", 19, fwd_src, k1_tpu,
        loop["launches_by_stage"]["train"]["blend_fwd"]
        + loop["launches_by_stage"]["predict"]["blend_fwd"],
        loop["fwd19"]["max_abs_err"], loop["fwd19"],
        path="pseudo_label_loop training + identity prediction, hard scene",
        **occupancy["blend_fwd"][19]))
    kernels.append(kernel_entry(
        "blend_bwd", 19, bwd_src, k2_tpu, loop["launches_by_stage"]["train"]["blend_bwd"],
        loop["bwd19"]["max_abs_err"], loop["bwd19"],
        path="pseudo_label_loop training, hard scene", **k2_occupancy[19]))
    edit = results["edit"]
    kernels.append(kernel_entry(
        "blend_fwd", 19, fwd_src, k1_tpu,
        edit["launches"]["blend_fwd"] + edit["mask_launches"]["blend_fwd"],
        edit["fwd19"]["max_abs_err"], edit["fwd19"],
        path="edit_object_inpaint finetune + the hole masks' renders, hard scene",
        launches_by_path={"finetune": edit["launches"]["blend_fwd"],
                          "hole masks": edit["mask_launches"]["blend_fwd"],
                          "eval_hard_scene_checkpoint":
                              results["offline"]["checkpoint_launches"]["blend_fwd"]},
        indexed_launches_by_path={
            "hole masks": edit["mask_launches"]["blend_fwd_indexed"],
            "eval_hard_scene_checkpoint":
                results["offline"]["checkpoint_launches"]["blend_fwd_indexed"]},
        **occupancy["blend_fwd"][19]))
    kernels.append(kernel_entry(
        "blend_bwd", 19, bwd_src, k2_tpu, edit["launches"]["blend_bwd"],
        edit["bwd19"]["max_abs_err"], edit["bwd19"],
        path="edit_object_inpaint finetune, hard scene",
        **k2_occupancy[19]))
    multi, strips = results["multi_step"], results["multi_strips"]
    for name, src, tpu, t, occ in (("blend_fwd", fwd_src, k1_tpu, results["multi_fwd"],
                                    occupancy["blend_fwd"][19]),
                                   ("blend_bwd", bwd_src, k2_tpu, results["multi_bwd"],
                                    k2_occupancy[19])):
        kernels.append(kernel_entry(
            name, 19, src, tpu, multi["launches"][name], t["max_abs_err"], t,
            path=f"parallel train step, B = {MULTI_B}",
            launches_by_path={f"{MULTI_TIMED} timed B-view steps": multi["launches"][name],
                              "train CLI under torchrun, view_batch 4":
                              results["multi_cli"]["launches"][name]},
            train_step=multi, **occ))
    kernels.append(kernel_entry(
        "blend_fwd", 32, fwd_src, k1_tpu, strips["launches"]["blend_fwd"],
        strips["heaviest"]["max_abs_err"], strips["heaviest"],
        path=f"rasterize_sharded strips, {STRIP_W}x{STRIP_H} in {STRIPS}; times on the gathered "
             f"payload", indexed_launches=strips["launches"]["blend_fwd_indexed"],
        strips=[{k: e[k] for k in ("strip", "num_pairs", "ms", "bound_ms", "plain_ms")}
                for e in strips["per_strip"]], **occupancy["blend_fwd"][32]))
    viewer = results["viewer"]
    kernels.append(kernel_entry(
        "blend_fwd", 19, fwd_src, k1_tpu, viewer["launches"]["blend_fwd"],
        viewer["k1_1080p"]["max_abs_err"],
        viewer["k1_1080p"], path=f"viewer frames (NetworkGUI.poll_and_render), the "
                                 f"{FRAME_W}x{FRAME_H} frame's inputs, gathered payload",
        launches_by_path={"viewer frames": viewer["launches"]["blend_fwd"],
                          f"train CLI with --port, {TOOLS_CLI_ITERS} iterations":
                          results["viewer_cli"]["launches"]["blend_fwd"]},
        indexed_launches_by_path={
            "viewer frames": viewer["launches"]["blend_fwd_indexed"],
            f"train CLI with --port, {TOOLS_CLI_ITERS} iterations":
                results["viewer_cli"]["launches"]["blend_fwd_indexed"]},
        **occupancy["blend_fwd"][19]))
    scale = results["scale"]
    kernels.append(kernel_entry(
        "blend_fwd", 32, fwd_src, k1_tpu, results["launches"]["scale"]["blend_fwd"],
        scale["k1"]["max_abs_err"], scale["k1"],
        path=f"officescene_scale_run stage 5: {SCALE_VIEWS} views at 876x584, 13 logits padded "
             f"to 32 channels; times on view 0's inputs, gathered payload",
        indexed_launches=results["launches"]["scale"]["blend_fwd_indexed"],
        **occupancy["blend_fwd"][32]))
    kernels.append(kernel_entry(
        "blend_fwd", 32, fwd_src, k1_tpu, launches["bench"]["blend_fwd"],
        headline["max_abs_err"], headline,
        path=f"python -m segsplat_tpu_torch.bench: {launches['bench']['blend_fwd_indexed']} "
             f"headline and hostile 1080p frames on blend_fwd_indexed; times on phase 3's "
             f"headline frame (the bench's frame 0), gathered payload",
        launches_by_path={"bench": launches["bench"]["blend_fwd"],
                          "perf_raster_stages": launches["perf_raster_stages"]["blend_fwd"]},
        hostile=results["scenes"]["hostile"], **occupancy["blend_fwd"][32]))
    for name, src, tpu, t, occ in (("blend_fwd", fwd_src, k1_tpu, results["train_fwd"],
                                    occupancy["blend_fwd"][19]),
                                   ("blend_bwd", bwd_src, k2_tpu, results["train_bwd"],
                                    k2_occupancy[19])):
        kernels.append(kernel_entry(
            name, 19, src, tpu, launches["perf_train"][name], t["max_abs_err"], t,
            path=f"python -m segsplat_tpu_torch.perf_train: {launches['perf_train'][name]} "
                 f"steps; times on phase 5's step-1 inputs (the same configuration and step)",
            **occ))
    comp = results["compile"]
    entry = comp["entry"]
    frames = comp["frames"]
    kernels.append(kernel_entry(
        "blend_fwd", entry["ch"], fwd_src, k1_tpu, entry["k1_launches"] + 1,
        entry["fwd"]["max_abs_err"], entry["fwd"],
        path="torch.compile (Inductor, fullgraph) of graft_entry.entry()'s 64x64 frame and of "
             "the 1080p headline frame; times on the compiled entry call's inputs",
        launches_by_path={"graft_entry.entry() compiled": entry["k1_launches"],
                          "1080p headline frame compiled": frames["headline"]["launches"]},
        compiled_frames=frames, **occupancy["blend_fwd"][entry["fwd"]["kernel_width"]]))
    kernels.append(kernel_entry(
        "blend_bwd", entry["ch"], bwd_src, k2_tpu, entry["k2_launches"],
        entry["bwd"]["max_abs_err"], entry["bwd"],
        path="the backward of the compiled graft_entry.entry() frame",
        **k2_occupancy[entry["bwd"]["kernel_width"]]))
    proj_launches = results["launches"]["render_semantics"]["project"]
    kernels.append(kernel_entry(
        "project", None, project_src, "none: XLA ops, segsplat_tpu/ops/rasterize.py "
        "project_gaussians", proj_launches, 0.0, results["project"],
        path="render_semantics CLI (no grad); times on phase 3's headline frame",
        launches_by_path={"render_semantics CLI": proj_launches},
        **{k: results["project"][k] for k in ("call_ms", "host_ms", "plain_host_ms",
                                              "bytes", "gaussians")}))
    pbwd, step_bwd = results["project_bwd"], results["train_step"]["project_launches"][1]
    kernels.append(kernel_entry(
        "project_bwd", None, project_src, "none: jax.grad of XLA ops, "
        "segsplat_tpu/ops/rasterize.py project_gaussians", step_bwd, pbwd["max_abs_err"], pbwd,
        path=f"train step, autograd's backward of the projection once a step: {step_bwd} in "
             f"phase 5's steps, {measure['project_launches']['perf_train'][1]} in perf_train; "
             f"times on phase 5's table, {TRAIN_W}x{TRAIN_H}",
        **{k: pbwd[k] for k in ("call_ms", "host_ms", "plain_host_ms", "bytes", "gaussians",
                                "grad_max_abs_diff")}))
    log(f"[total] {time.perf_counter() - t_all:.1f} s on {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
