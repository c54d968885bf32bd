"""Harness entry points: the compile check of one flagship frame and the dry
run of the three programs on several devices (the counterpart of the root
``__graft_entry__.py``).

``entry(device)`` returns ``(forward, example_args)``: the semantic-render
forward of the flagship model (a Gaussian table and the 32-channel logit pass,
the reference's FPS path, voxel_to_gaussian/render_semantics_logits.py:92-105).
``torch.compile(forward, fullgraph=True)(*example_args)`` compiles it as one
graph, the counterpart of ``jax.jit(fn)(*args)``: the blends K1 and K2 are
registered ops (``ops/blend.py``), so nothing in the frame breaks the graph.

``dryrun_multichip(n, device)`` runs the three programs of the
(view × tensor) mesh on n ranks, one process a device (``parallel/``):
  1. one B-view training step (render forward and backward, every loss, both
     optimizers), the views split over ``view`` and the codebook's logit rows
     over ``tensor``, held to the same step in a world of one;
  2. one sharded feature lift (views over ``view``, channels over
     ``tensor``, the voxel sums reduced over the ranks);
  3. one strip render (rows over ``view``).
``device="cuda"`` takes n cards (NCCL); ``device="cpu"`` runs n gloo ranks
on the CPU, which the caller asks for, as the JAX dry run takes n virtual CPU
devices. The ranks are processes of this module
(``python -m segsplat_tpu_torch.graft_entry --worker ...``) that meet at a
``file://`` rendezvous in a temporary directory.

    python -m segsplat_tpu_torch.graft_entry

compiles and runs ``entry()`` on the card, then dry-runs on every card when
there are several, else on 8 gloo ranks on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from segsplat_tpu_torch.utils.system import require_device

TRAIN_GAUSSIANS, TRAIN_CAPACITY, TRAIN_SIZE = 128, 192, 32
TRAIN_RASTER = dict(max_tiles_per_axis=4, max_per_tile=64, tile_chunk=4)
STEP_RTOL, STEP_ATOL = 1e-3, 1e-5       # the sharded step against the world of one
LIFT_SIZE, LIFT_VIEWS_A_SHARD, LIFT_CHANNELS_A_SHARD = 24, 2, 16
STRIP_GAUSSIANS = 96
RANK_TIMEOUT = 600.0                    # seconds for the ranks of one dry run


def _tiny_scene(n_gauss: int = 256, capacity: int = 384, seed: int = 0,
                sh_degree: int = 1, device="cuda"):
    from segsplat_tpu_torch.train.trainer import init_table_from_pcd

    rng = np.random.default_rng(seed)
    pts = (rng.random((n_gauss, 3)) * 2 - 1).astype(np.float32)
    cols = rng.random((n_gauss, 3)).astype(np.float32)
    return init_table_from_pcd(pts, cols, capacity, max_sh_degree=sh_degree, device=device)


def _cam(i: int, n: int, height: int = 64, width: int = 64, device="cuda"):
    from segsplat_tpu_torch.core.types import Camera

    ang = 2 * np.pi * i / max(n, 1)
    pos = np.array([3 * np.sin(ang), 0.0, -3 * np.cos(ang)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd], axis=1).astype(np.float32)
    T = (-R.T @ pos).astype(np.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Camera(R=f32(R), T=f32(T), fov_x=f32(0.9), fov_y=f32(0.9), width=width,
                  height=height)


def entry(device="cuda"):
    """(forward, example_args): the semantic-render forward of the flagship
    model, ``forward(table, camera, logits, bg) → (render [3, 64, 64],
    semantic_logits [32, 64, 64], radii [384])`` on a 256-Gaussian table of
    capacity 384 (SH degree 1), 32 logits, m = 4, K = 128, through K1."""
    from segsplat_tpu_torch.render import render

    device = require_device(device)
    table = _tiny_scene(device=device)
    camera = _cam(0, 1, device=device)
    rng = np.random.default_rng(1)
    logits = torch.as_tensor(rng.standard_normal((table.capacity, 32)).astype(np.float32),
                             device=device)
    bg = torch.zeros((3,), dtype=torch.float32, device=device)

    def forward(table, camera, logits, bg):
        out = render(table, camera, bg, semantic_logits=logits,
                     max_tiles_per_axis=4, max_per_tile=128, tile_chunk=8)
        return out["render"], out["semantic_logits"], out["radii"]

    return forward, (table, camera, logits, bg)


# ───────────────────────────── the dry run's programs ─────────────────────────────

def mesh_shape(n_devices: int) -> tuple:
    """(n_view, n_tensor): the tensor axis 2 where n is even, else 1."""
    n_tensor = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // n_tensor, n_tensor


def _train_inputs(n_view: int, device):
    """Program 1's state and batch, the same on every rank and in the world
    of one: (state, cfg, cameras, gt images, gt objects, bg, contrastive idx)
    and the numpy generator, which programs 2 and 3 draw on from there."""
    from segsplat_tpu_torch.core.types import stack_cameras
    from segsplat_tpu_torch.train.losses import CONTRAST_SAMPLES
    from segsplat_tpu_torch.train.trainer import OptimizationConfig, init_state

    table = _tiny_scene(TRAIN_GAUSSIANS, TRAIN_CAPACITY, device=device)
    cfg = OptimizationConfig(num_classes=16)
    state = init_state(table, cfg, spatial_lr_scale=1.0)
    V, H, W = n_view, TRAIN_SIZE, TRAIN_SIZE
    rng = np.random.default_rng(2)
    cams = stack_cameras([_cam(i, V, H, W, device=device) for i in range(V)])
    gt_img = torch.as_tensor(rng.random((V, 3, H, W)).astype(np.float32), device=device)
    gt_obj = torch.as_tensor(rng.integers(0, 16, (V, H, W)), device=device)
    bg = torch.zeros((3,), dtype=torch.float32, device=device)
    idx = torch.randint(0, H * W, (V, CONTRAST_SAMPLES),
                        generator=torch.Generator().manual_seed(0)).to(device)
    return (state, cfg, cams, gt_img, gt_obj, bg, idx), rng


def _train_step(mesh, inputs) -> dict:
    """One B-view step on ``mesh``: the metrics, ``xyz`` and ``code_book`` after it."""
    from segsplat_tpu_torch.parallel import make_parallel_train_step
    from segsplat_tpu_torch.parallel.train import MEAN_KEYS, replicate_state

    state, cfg, cams, gt_img, gt_obj, bg, idx = inputs
    replicate_state(state, mesh)
    step = make_parallel_train_step(cfg, mesh, TRAIN_RASTER)
    metrics = step(state, cams, gt_img, gt_obj, bg, idx=idx)
    out = {f"m_{k}": float(metrics[k]) for k in MEAN_KEYS}
    out["xyz"] = state.table.xyz.detach().cpu().numpy()
    out["code_book"] = state.code_book.detach().cpu().numpy()
    return out


def _lift_program(mesh, rng, device) -> dict:
    """Program 2: the sharded lift of 2 views a view-shard at 24×24 on an 8³
    grid with 64 occupied voxels, 16 channels a tensor rank."""
    from segsplat_tpu_torch.ops.lift import default_max_steps
    from segsplat_tpu_torch.parallel import lift_views_sharded

    V = mesh.n_view * LIFT_VIEWS_A_SHARD
    H = W = LIFT_SIZE
    C = LIFT_CHANNELS_A_SHARD * mesh.n_tensor
    occ = np.zeros((8, 8, 8), np.int32)
    occ[2:6, 2:6, 2:6] = np.arange(1, 65).reshape(4, 4, 4)
    num_ids = int(occ.max()) + 1
    vs, inc, fx = 0.25, 0.125, 30.0
    feats = rng.random((V, H, W, C)).astype(np.float32)
    c2ws, intr = [], []
    for i in range(V):
        ang = 2 * np.pi * i / V
        pos = np.array([2.5 * np.sin(ang), 0.0, -2.5 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(fwd, right)
        c2w[:3, 2], c2w[:3, 3] = fwd, pos
        c2ws.append(c2w)
        intr.append([fx, fx, W / 2, H / 2])
    steps = default_max_steps(W, H, fx, fx, 0.5, 6.0, inc)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    sums, counts = lift_views_sharded(
        mesh, f32(feats), torch.as_tensor(occ, device=device), f32(np.stack(c2ws)),
        f32(intr), f32([-1.0, -1.0, -1.0]), f32(vs), 0.5, 6.0, inc, num_ids, steps)
    return {"lift_sums": sums.cpu().numpy(), "lift_counts": counts.cpu().numpy(),
            "lift_views": V, "lift_channels": C}


def _strip_program(mesh, rng, device) -> dict:
    """Program 3: a 96-Gaussian scene's frame in n_view TILE-aligned strips."""
    from segsplat_tpu_torch.ops.rasterize import TILE
    from segsplat_tpu_torch.parallel import rasterize_sharded

    Hs = Ws = max(mesh.n_view * TILE, 2 * TILE)
    cam = _cam(0, 1, Hs, Ws, device=device)
    n = STRIP_GAUSSIANS
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    fx = float(0.5 * Ws / np.tan(0.45))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    out = rasterize_sharded(
        mesh, f32(rng.random((n, 3)) * 2 - 1), f32(np.full((n, 3), 0.05)), f32(quats),
        f32(rng.uniform(0.5, 1.0, n)), f32(rng.random((n, 3))),
        cam.world_view_transform(), fx, fx, Ws / 2, Hs / 2, Ws, Hs,
        max_tiles_per_axis=4, max_per_tile=64, tile_chunk=4)
    return {"strip_image": out["image"].cpu().numpy()}


def _worker(rank: str, world: str, init: str, workdir: str, device: str) -> int:
    """One rank of the dry run: join the group, run the three programs on the
    mesh, save what they return to ``workdir/rank<r>.npz``."""
    from segsplat_tpu_torch.parallel import make_mesh, multihost

    rank, world = int(rank), int(world)
    if device == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(f"file://{init}", world, rank,
                         backend="gloo" if device == "cpu" else "nccl")
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    try:
        mesh = make_mesh(*mesh_shape(world))
        inputs, rng = _train_inputs(mesh.n_view, dev)
        out = _train_step(mesh, inputs)
        out.update(_lift_program(mesh, rng, dev))
        out.update(_strip_program(mesh, rng, dev))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _run_ranks(world: int, device: str, workdir: str) -> list:
    """Start ``world`` rank processes and wait for them; raises, after killing
    them all, when one fails or they outlast RANK_TIMEOUT. Returns each rank's
    saved arrays."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    init = os.path.join(workdir, "rendezvous")
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "segsplat_tpu_torch.graft_entry", "--worker", str(rank),
             str(world), init, workdir, device], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=workdir), log))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"the dry run's {world} ranks outlasted {RANK_TIMEOUT} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = []
    for rank, (p, log) in enumerate(procs):
        if p.returncode != 0:
            with open(log.name) as f:
                bad.append(f"rank {rank}: exit {p.returncode}\n{f.read()[-3000:]}")
    if bad:
        raise RuntimeError("dry-run ranks failed:\n" + "\n".join(bad))
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(world)]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The three programs on an n-rank (view × tensor) mesh, tensor 2 where n
    is even. The train step is held on every rank to the same step in a world
    of one (run first, in this process: a mesh must cover its world) at rtol
    1e-3, atol 1e-5 on every mean metric and on ``xyz`` and ``code_book``;
    the lift must hit voxels with finite sums and the strips give a finite
    frame, the same on every rank. ``device="cuda"`` needs n cards."""
    from segsplat_tpu_torch.parallel import make_mesh
    from segsplat_tpu_torch.parallel.train import MEAN_KEYS

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda needs {n_devices} cards, "
                           f"and this machine has {torch.cuda.device_count()}; pass "
                           f"device='cpu' for {n_devices} gloo ranks on the CPU")
    device = require_device(device)
    t0 = time.perf_counter()
    n_view, n_tensor = mesh_shape(n_devices)
    shape = {"view": n_view, "tensor": n_tensor}
    ref = _train_step(make_mesh(), _train_inputs(n_view, device)[0])
    with tempfile.TemporaryDirectory(prefix="graft_dryrun_") as workdir:
        ranks = _run_ranks(n_devices, device.type, workdir)

    for rank, got in enumerate(ranks):
        for k in MEAN_KEYS:
            a, b = ref[f"m_{k}"], float(got[f"m_{k}"])
            if not np.isclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL):
                raise AssertionError(f"rank {rank}: sharded metric {k!r} diverged from the "
                                     f"world of one: {b} vs {a}")
        for name in ("xyz", "code_book"):
            np.testing.assert_allclose(
                got[name], ref[name], rtol=STEP_RTOL, atol=STEP_ATOL,
                err_msg=f"rank {rank}: sharded {name} update diverged from the world of one")
    total = float(ranks[0]["m_total"])
    if not np.isfinite(total):
        raise AssertionError(f"non-finite loss from the sharded step: {total}")
    print(f"dryrun_multichip ok: mesh={shape} total_loss={total:.4f} (single-device "
          f"equivalence: |Δtotal|={abs(total - ref['m_total']):.2e})", flush=True)

    for key in ("lift_sums", "lift_counts", "strip_image"):
        for rank, got in enumerate(ranks[1:], 1):
            np.testing.assert_array_equal(got[key], ranks[0][key],
                                          err_msg=f"rank {rank}'s {key} differs from rank 0's")
    sums, counts = ranks[0]["lift_sums"], ranks[0]["lift_counts"]
    hits = int(counts.sum())
    if hits <= 0 or not np.isfinite(sums).all():
        raise AssertionError(f"sharded lift: {hits} voxel hits, finite sums "
                             f"{bool(np.isfinite(sums).all())}")
    print(f"dryrun_multichip lift ok: mesh={shape} views={int(ranks[0]['lift_views'])} "
          f"channels={int(ranks[0]['lift_channels'])} voxel_hits={hits}", flush=True)

    image = ranks[0]["strip_image"]
    side = max(n_view * 16, 32)
    if image.shape != (side, side, 3) or not np.isfinite(image).all():
        raise AssertionError(f"strip render: image {image.shape}, finite "
                             f"{bool(np.isfinite(image).all())}")
    print(f"dryrun_multichip render ok: mesh={shape} strips={n_view} image={side}x{side} "
          f"(the dry run {time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return _worker(*argv[1:])
    fn, args = entry()
    t0 = time.perf_counter()
    out = torch.compile(fn, fullgraph=True)(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out],
          f"(compiled and run in {time.perf_counter() - t0:.1f} s)", flush=True)
    n = torch.cuda.device_count()
    if n > 1:
        dryrun_multichip(n, device="cuda")
    else:
        print("[graft_entry] one card: the dry run takes 8 gloo ranks on the CPU", flush=True)
        dryrun_multichip(8, device="cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
