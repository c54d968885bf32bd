#!/usr/bin/env python
"""Perf guard: deterministic counts of the exported programs of the bench's
three configurations (headline render, hostile render, officescene lift), with
a wall clock beside them. The twin of scripts/perf_guard.py.

Each program is exported with ``torch.export.export`` at the bench's shapes
(the scenes of ``segsplat_tpu_torch.bench``). The blends are registered ops
(``ops/blend.py``), one opaque node each, so the counts cover everything
around the kernel (projection, binning, sorts, gathers, the lift's resize,
first hit and accumulation), as the JAX guard's XLA program does:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the exported
    graph, run on its own fake tensors;
  * ``bytes_accessed``: Σ over the graph's operator nodes of the bytes of
    their tensor inputs and outputs (``meta["val"]``);
  * ``temp_bytes``: the peak of the live intermediate bytes, walking the graph
    in order and freeing each value after its last use;
  * ``nodes``: the operator nodes by op.

They depend on the program and its shapes alone, not on the device nor on the
data. ``export_s`` is the seconds the export and the counts took.
``wall_s_per_unit`` is the exported program's wall time a frame or a
view on ``--device``: CUDA events on the card (the least of 3 calls after one
untimed call), the host clock on the CPU. A change of a count beyond
COUNT_TOLERANCE, or of the wall time beyond WALL_TOLERANCE, is drift.

    python -m segsplat_tpu_torch.perf_guard [--device cuda|cpu] [--out OUT.json]
        [--compare BASE.json] [--no-walltime]

prints one JSON line; with ``--compare`` it prints each key's change and exits
1 on drift. The JAX guard's own results (``results/perf_guard_r5.json``) hold
XLA's counts, which these are not comparable with.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from argparse import ArgumentParser

import torch
from torch.utils.flop_counter import FlopCounterMode

from segsplat_tpu_torch import bench
from segsplat_tpu_torch.ops.lift_splat import lift_view_splat
from segsplat_tpu_torch.ops.rasterize import rasterize
from segsplat_tpu_torch.perf_raster_stages import SCENE_NAMES, bench_intrinsics
from segsplat_tpu_torch.pipeline.lift_features import resize_features
from segsplat_tpu_torch.utils.system import require_device

WALL_TOLERANCE = 0.25
COUNT_TOLERANCE = 0.01
WALL_CALLS = 3


class Program(torch.nn.Module):
    """A function of tensors as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def render_program(scene: dict):
    """(fn, arrays, units): one frame of ``scene`` (``rasterize`` on K1, then
    the argmax over the channels summed over the pixels, scripts/perf_guard.py:65-73),
    on bench.py's camera."""
    kw = scene["kw"]
    cam = bench_intrinsics(scene["W"], scene["H"])

    def one_frame(xyz, scales, quats, opac, logits, vm):
        bg = torch.zeros((logits.shape[1],), dtype=torch.float32, device=xyz.device)
        out = rasterize(xyz, scales, quats, opac, logits, vm, *cam, kw["width"], kw["height"],
                        bg=bg, max_tiles_per_axis=kw["max_tiles_per_axis"],
                        max_per_tile=kw["max_per_tile"], backend=kw["backend"],
                        pair_cap=kw["pair_cap"])
        return out["image"].argmax(-1).to(torch.int32).sum()

    arrays = tuple(scene[k] for k in SCENE_NAMES) + (torch.eye(4),)
    return one_frame, arrays, 1


def lift_program(scene: dict):
    """(fn, arrays, units): the lift of every view of ``scene`` into one table
    (scripts/perf_guard.py:75-105, a loop for its ``lax.scan``): the ×2
    bilinear upsample of the view's fp16 map, the transpose to HWC and
    ``lift_view_splat`` (m = 8, K = 128); a few sums of the table."""
    W, H, C, vs = scene["W"], scene["H"], scene["C"], scene["vs"]
    num_ids = scene["centers"].shape[0] + 1

    def lift_all(feats, c2ws, intr, centers, ids):
        f32 = dict(dtype=torch.float32, device=feats.device)
        s = torch.zeros((num_ids, C), **f32)
        c = torch.zeros((num_ids,), dtype=torch.int32, device=feats.device)
        for v in range(feats.shape[0]):
            fmap = resize_features(feats[v], H, W).permute(1, 2, 0)
            ds, dc, _ = lift_view_splat(centers, ids, c2ws[v], intr[v], torch.tensor(vs, **f32),
                                        0.01, 10.0, torch.tensor(vs * 0.5, **f32), fmap,
                                        num_ids, W, H, max_tiles_per_axis=8, max_per_tile=128)
            s, c = s + ds, c + dc
        return s[::64, ::64].sum() + c[::64].sum()

    arrays = tuple(scene[k] for k in ("feats", "c2ws", "intr", "centers", "ids"))
    return lift_all, arrays, int(scene["feats"].shape[0])


def programs(width: int = 1920, height: int = 1080, n: int = 200_000,
             lift_views: int = bench.LIFT_VIEWS, lift_size=bench.LIFT_SIZE) -> dict:
    """The three programs at the bench's sizes unless given smaller ones."""
    return {
        "headline_render_1080p_200k": render_program(bench.headline_render_scene(width, height, n)),
        "hostile_render_1080p_200k": render_program(bench.hostile_render_scene(width, height, n)),
        f"lift_officescene_{lift_views}views":
            lift_program(bench.officescene_lift_scene(lift_views, lift_size)),
    }


def _tensors(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


def _bytes(value) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(value))


def graph_counts(ep) -> dict:
    """flops, bytes_accessed, temp_bytes and nodes of an exported program."""
    graph = ep.graph_module.graph
    ops = [n for n in graph.nodes if n.op == "call_function"]
    val = lambda node: node.meta.get("val")
    bytes_accessed = sum(_bytes(val(n)) + sum(_bytes(val(a)) for a in n.all_input_nodes)
                         for n in ops)
    last_use = {}
    for i, n in enumerate(graph.nodes):
        for a in n.all_input_nodes:
            last_use[a] = i
    live = peak = 0
    for i, n in enumerate(graph.nodes):
        if n.op == "call_function":
            live += _bytes(val(n))
            peak = max(peak, live)
        for a in n.all_input_nodes:
            if last_use[a] == i and a.op == "call_function":
                live -= _bytes(val(a))
    fake = [val(n) for n in graph.nodes if n.op == "placeholder"]
    with fake[0].fake_mode, FlopCounterMode(display=False) as counter:
        ep.module()(*fake[len(fake) - len(ep.example_inputs[0]):])
    nodes = collections.Counter(str(n.target) for n in ops)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float(bytes_accessed),
            "temp_bytes": int(peak), "nodes": dict(sorted(nodes.items()))}


def wall_seconds(fn, args, device: torch.device) -> float:
    """The least wall time of ``fn(*args)`` over WALL_CALLS calls after one
    untimed call: CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    times = []
    for _ in range(WALL_CALLS):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return min(times)


def measure(walltime: bool = True, device="cuda", **sizes) -> dict:
    """Counts (and with ``walltime`` the wall time a unit) of each program,
    exported on ``device``; ``sizes`` go to ``programs``."""
    device = require_device(device)
    out = {"device": str(device), "torch_version": torch.__version__}
    for name, (fn, arrays, units) in programs(**sizes).items():
        args = tuple(torch.as_tensor(a, device=device) for a in arrays)
        t0 = time.perf_counter()
        ep = torch.export.export(Program(fn), args)
        row = {"units_per_call": units, **graph_counts(ep),
               "export_s": time.perf_counter() - t0}
        if walltime:
            row["wall_s_per_unit"] = wall_seconds(ep.module(), args, device) / units
        out[name] = row
        del args, ep
    return out


def compare(baseline: dict, current: dict) -> int:
    """Print per-config deltas; return the number of out-of-tolerance rows."""
    bad = 0
    for name, base in baseline.items():
        if not isinstance(base, dict) or name not in current:
            continue
        cur = current[name]
        for key, tol in (("flops", COUNT_TOLERANCE),
                         ("bytes_accessed", COUNT_TOLERANCE),
                         ("temp_bytes", COUNT_TOLERANCE),
                         ("wall_s_per_unit", WALL_TOLERANCE)):
            if key not in base or key not in cur:
                continue
            b, c = float(base[key]), float(cur[key])
            if b <= 0:
                continue
            rel = (c - b) / b
            flag = "OK" if abs(rel) <= tol else "DRIFT"
            if flag == "DRIFT":
                bad += 1
            print(f"{flag:5s} {name}.{key}: {b:.4g} -> {c:.4g} "
                  f"({rel:+.1%}, tol ±{tol:.0%})")
    return bad


def main(argv=None):
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write JSON here")
    p.add_argument("--compare", default=None,
                   help="baseline JSON to diff against (exit 1 on drift)")
    p.add_argument("--no-walltime", action="store_true", help="counts only")
    args = p.parse_args(argv)

    cur = measure(walltime=not args.no_walltime, device=args.device)
    print(json.dumps(cur), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cur, f, indent=1)
    if args.compare:
        with open(args.compare) as f:
            base = json.load(f)
        if compare(base, cur):
            sys.exit(1)


if __name__ == "__main__":
    main()
