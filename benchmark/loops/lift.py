"""The lift loop: stage 3's views back to back, as the lift CLI's sweep runs
them, through the program's per-view lift. A view is

    lifter.lift(maps[i % maps], c2w[i % views], intrinsics)

(``segsplat_tpu_torch.pipeline.lift_features.ViewLifter``): the fp16 map
copied from pageable host memory to the card, resized to the ray grid, lifted
to its rays' first-hit voxels and added into one pair of accumulators for the
whole run. The CLI's file reads and checkpoint writes are left out: they
measure the disk.

The check: the accumulators' change over the window's first view and over
every ``keep_every``-th view after a phase drawn from the seed is kept (a
copy of the sums and counts before the view, the difference after it). Once
the window has closed, ``check_views`` of the kept views, drawn from the
seed, are lifted again by the plain reference (``reference/lift.py``) in
float32 at full size, and

  * ``hit_mismatch_share``: the largest, over the views checked, of
    Σ|Δcounts − counts| / (2·rays): the share of rays lifted into another
    voxel than the reference's (a ray lifted elsewhere counts twice, a ray
    lifted or dropped alone once);
  * ``sum_gap_max``: the largest |Δsums − sums| over the voxels whose counts
    agree, relative to the reference's largest |sums| of that view.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.reference import lift as reference


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.cfg, self.mix = cell.config, cell.traffic
        self.overrides = {}              # LiftConfig fields a planted fault changes
        self.kept = {}
        self.next_index = 0
        self.lifter = None
        self.occ = None                  # the reference's occupancy, built on first use
        self.view_fn = self.program_view

    # ---- the system under test ---------------------------------------------
    def setup(self) -> None:
        from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, ViewLifter

        cfg = self.cfg
        s = self.cell.scene_module().draw(cfg, self.seed, self.dev)
        self.scene = s
        lcfg = LiftConfig(depth_min=cfg["depth_min"], depth_max=cfg["depth_max"],
                          ray_increment_factor=cfg["ray_increment_factor"],
                          downsample_factor=cfg["downsample"],
                          splat_max_tiles_per_axis=cfg["max_tiles_per_axis"],
                          splat_max_per_tile=cfg["max_per_tile"],
                          splat_big_budget=cfg["big_budget"])
        self.lifter = ViewLifter(s["centers"], cfg["cell_size"], s["origin"],
                                 tuple(int(v) for v in s["cells"].max(axis=0) + 1),
                                 cfg["channels"], cfg["height"], cfg["width"],
                                 dataclasses.replace(lcfg, **self.overrides), self.dev)
        rng = np.random.default_rng([self.seed % 2 ** 64, 0x11F7])
        self.keep_phase = int(rng.integers(self.mix["keep_every"]))
        self.check_rng = rng
        warmup = int(self.mix["warmup"])
        for i in range(warmup):
            self.view_fn(i)
        self.drain()
        self.next_index = warmup

    def inputs(self, i: int):
        s = self.scene
        return s["maps"][i % len(s["maps"])], s["c2w"][i % len(s["c2w"])], s["intrinsics"]

    def program_view(self, i: int) -> None:
        self.lifter.lift(*self.inputs(i))

    def iterate(self, i: int) -> dict:
        j = i - self.next_index
        keep = j == 0 or (j % self.mix["keep_every"]) == self.keep_phase
        if keep:
            before = (self.lifter.sums.clone(), self.lifter.counts.clone())
        t0 = time.perf_counter()
        self.view_fn(i)
        t1 = time.perf_counter()
        if keep:
            self.kept[i] = (torch.sub(self.lifter.sums, before[0], out=before[0]),
                            torch.sub(self.lifter.counts, before[1], out=before[1]))
        return {"call": t1 - t0}

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def aside(self, i: int) -> None:
        pass

    # ---- the yardstick -----------------------------------------------------
    def reference_hits(self, i: int) -> torch.Tensor:
        """The reference's first-hit ids [H·W] of view i."""
        cfg, s = self.cfg, self.scene
        if self.occ is None:
            self.occ = reference.occupancy(torch.as_tensor(s["cells"], device=self.dev))
        _, c2w, intr = self.inputs(i)
        return reference.march(self.occ, torch.as_tensor(s["origin"], device=self.dev),
                               cfg["cell_size"], torch.as_tensor(c2w, device=self.dev),
                               intr, cfg["width"], cfg["height"], cfg["depth_min"],
                               cfg["depth_max"], cfg["cell_size"] * cfg["ray_increment_factor"])

    def reference_view(self, i: int, map_dtype=torch.float32):
        """The reference's (sums [V+1, C], counts [V+1]) of view i."""
        cfg = self.cfg
        fmap = reference.resize(torch.from_numpy(self.inputs(i)[0]).to(self.dev),
                                cfg["height"], cfg["width"])
        return reference.lift_view(fmap, self.reference_hits(i), len(self.scene["cells"]) + 1,
                                   map_dtype=map_dtype)

    def work(self, traced) -> list:
        """Each traced view's bytes and operations (``reference.view_bytes``,
        ``view_ops``), from the reference's march."""
        cfg, out = self.cfg, []
        for i in traced:
            hits = self.reference_hits(i)
            got = hits[hits > 0]
            out.append({"bytes": reference.view_bytes(cfg["channels"], cfg["map_h"],
                                                      cfg["map_w"], int(got.unique().numel())),
                        "ops": reference.view_ops(int(got.numel()), cfg["channels"])})
        return out

    def release(self) -> None:
        self.lifter = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """[(name, value, limit)] over views drawn from the seed among those kept."""
        kept = sorted(self.kept)
        n = min(int(self.mix["check_views"]), len(kept))
        picks = sorted(self.check_rng.choice(kept, size=n, replace=False)) if n else []
        share, gap = (float("nan"), float("nan")) if not picks else (0.0, 0.0)
        rays = self.cfg["width"] * self.cfg["height"]
        for i in picks:
            s, g = compare(*self.kept[int(i)], *self.reference_view(int(i)), rays)
            share, gap = max(share, s), max(gap, g)
        lim = self.mix["limits"]
        return [("hit_mismatch_share", share, lim["hit_mismatch_share"]),
                ("sum_gap_max", gap, lim["sum_gap_max"])]


def compare(sums, counts, ref_sums, ref_counts, rays: int):
    """(hit_mismatch_share, sum_gap_max) of one view's sums and counts
    [V+1, ...] against the reference's (the module docstring); row 0, no
    voxel's, is left out. inf where the shapes differ."""
    if sums.shape != ref_sums.shape or counts.shape != ref_counts.shape:
        return float("inf"), float("inf")
    diff = (counts[1:].long() - ref_counts[1:].long()).abs()
    agree = diff == 0
    scale = float(ref_sums.abs().max())
    gap = float((sums[1:][agree] - ref_sums[1:][agree]).abs().max()) if bool(agree.any()) else 0.0
    return float(diff.sum()) / (2 * rays), (gap / scale if scale > 0 else float("inf"))


def plant(loop: Loop, fault: str):
    """Put a broken view in the program's place, for the harness's tests and
    ``tools/readings.py``, before set-up: ``control`` (the reference, its
    resized map in bfloat16, added into the program's accumulators), ``k32``
    (the program with 32 candidates a tile, whose truncation changes hits:
    at 64 or 128 it truncates too, but a tile's nearest 64 cubes hold every
    ray's first hit on this orbit) or ``coarse_march`` (the program marching
    10 % coarser steps). Returns a function that undoes it."""
    program = loop.program_view

    def control(i):
        ds, dc = loop.reference_view(i, map_dtype=torch.bfloat16)
        loop.lifter.sums += ds
        loop.lifter.counts += dc.to(torch.int32)

    if fault == "control":
        loop.view_fn = control
    elif fault == "k32":
        loop.overrides = {"splat_max_per_tile": 32}
    elif fault == "coarse_march":
        loop.overrides = {"ray_increment_factor": loop.cfg["ray_increment_factor"] * 1.1}
    else:
        raise KeyError(fault)

    def undo():
        loop.view_fn = program
        loop.overrides = {}
    return undo


FAULTS = ("k32", "coarse_march")
