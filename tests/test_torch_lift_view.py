"""The per-view lift (segsplat_tpu_torch/pipeline/lift_features.ViewLifter)
on a small furnished room on the CPU: 1 200 of the production run's room
points in 0.3 m cells (585 voxels), three of its orbit cameras at 64×48 rays,
eight channels. The lifter gives the same bits and artifacts as
``aggregate_voxel_features`` (splat and DDA); the benchmark's plain reference
(benchmark/reference/lift.py) and its check (benchmark/loops/lift.py
``compare``) hold it within the lift cell's limits, and catch a truncating K
and the bfloat16 control; the view's spans and overflow count are recorded;
the benchmark scene's copy of the room's draw is the program's."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness.cell import BENCH_DIR, load_module
from benchmark.reference import lift as reference
from segsplat_tpu_torch.io.artifacts import load_feature_map
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply, write_voxel_grid_ply
from segsplat_tpu_torch.officescene_scale_run import room_points
from segsplat_tpu_torch.pipeline import lift_features as PF
from segsplat_tpu_torch.utils import profiling
from tests._torch_port import torch_threads

SCENE = load_module(BENCH_DIR / "scenes" / "room_lift.py")
LOOP = load_module(BENCH_DIR / "loops" / "lift.py")
LIMITS = json.loads((BENCH_DIR / "traffic" / "lift.json").read_text())["limits"]
ROOM = dict(points=1200, layout_seed=0, density_eps=0.08, density_min_neighbors=0,
            cell_size=0.3, views=3, native_w=128, native_h=96, fx_native=100.0,
            downsample=0.5)
W, H, C, N_VIEWS = 64, 48, 8, 3


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The small room as stage 1 and the orbit leave it on disk: its grid PLY,
    three fp16 maps [C, 24, 32] and the camera JSON ``fabricate`` writes."""
    root = tmp_path_factory.mktemp("room")
    cells, origin, centers = SCENE.voxels(ROOM)
    ply = str(root / "grid.ply")
    write_voxel_grid_ply(ply, centers, np.full((len(centers), 3), 127, np.uint8),
                         ROOM["cell_size"], origin, grid_shape=tuple(cells.max(0) + 1))
    c2w, _ = SCENE.cameras(ROOM)
    lseg = root / "lseg"
    lseg.mkdir()
    images = {}
    rng = np.random.default_rng(4)
    for i in range(N_VIEWS):
        np.save(lseg / f"frame_{i:03d}.npy",
                rng.standard_normal((C, H // 2, W // 2)).astype(np.float16))
        R = c2w[i, :3, :3].T.astype(np.float64)
        images[str(i + 1)] = {"name": f"frame_{i:03d}.png", "R": R.tolist(),
                              "tvec": (-R @ c2w[i, :3, 3]).tolist(), "camera_id": "1"}
    cams = str(root / "cams.json")
    with open(cams, "w") as f:
        json.dump({"images": images, "cameras": {"1": {
            "model": "PINHOLE", "width": ROOM["native_w"], "height": ROOM["native_h"],
            "params": [ROOM["fx_native"], ROOM["native_w"] / 2, ROOM["native_h"] / 2]}}}, f)
    return {"root": root, "ply": ply, "lseg": str(lseg), "cams": cams, "cells": cells}


def _lifter(room, cfg=PF.LiftConfig()):
    """A lifter on the room's grid PLY, and the views' (map, c2w, intrinsics)
    as the CLI reads them."""
    centers, _, vs, origin, shape = read_voxel_grid_ply(room["ply"])
    files = sorted(os.path.join(room["lseg"], f) for f in os.listdir(room["lseg"]))
    c2ws, intr, files = PF.camera_arrays_for(files, *PF.load_camera_json(room["cams"])[:2],
                                             cfg.downsample_factor)
    views = [(load_feature_map(f), c2ws[i], intr[i]) for i, f in enumerate(files)]
    return PF.ViewLifter(centers, vs, origin, shape, C, H, W, cfg, "cpu"), views


def _reference_hits(room, view):
    _, c2w, intr = view
    _, _, vs, origin, _ = read_voxel_grid_ply(room["ply"])
    return reference.march(reference.occupancy(torch.as_tensor(room["cells"])),
                           torch.as_tensor(origin), vs, torch.as_tensor(c2w), intr, W, H,
                           0.01, 10.0, vs * 0.5)


def _reference(room, view, map_dtype=torch.float32):
    """The reference's (sums, counts) of one view of the room."""
    return reference.lift_view(reference.resize(torch.from_numpy(view[0]), H, W),
                               _reference_hits(room, view), len(room["cells"]) + 1,
                               map_dtype=map_dtype)


@pytest.mark.parametrize("method", ["splat", "dda"])
def test_the_lifter_gives_the_clis_bits_and_artifacts(room, tmp_path, method):
    cfg = PF.LiftConfig(view_chunk=2, checkpoint_every=2, method=method)
    with torch_threads(2):
        cli = PF.aggregate_voxel_features(room["ply"], room["lseg"], room["cams"],
                                          str(tmp_path / "cli"), cfg, device="cpu")
        lifter, views = _lifter(room, cfg)
        for v in views:
            lifter.lift(*v)
    sums, counts, overflow = lifter.result()
    assert int((counts[1:] > 0).sum()) > 100 and overflow == cli["overflow"] == 0
    assert torch.equal(sums, cli["sums"]) and torch.equal(counts, cli["counts"])
    # the CLI's checkpoint at 2 views and its final artifact, from lifters
    centers, _, vs, origin, shape = read_voxel_grid_ply(room["ply"])
    for done, final in ((2, False), (N_VIEWS, True)):
        part = PF.ViewLifter(centers, vs, origin, shape, C, H, W, cfg, "cpu")
        for v in views[:done]:
            part.lift(*v)
        PF._write_artifacts(str(tmp_path / "api"), done, part.sums, part.counts, centers,
                            part.grid, vs, final)
    names = sorted(os.listdir(tmp_path / "cli"))
    assert names == sorted(os.listdir(tmp_path / "api")) and len(names) == 4
    for n in names:
        assert (tmp_path / "cli" / n).read_bytes() == (tmp_path / "api" / n).read_bytes(), n


def test_the_reference_and_the_check_hold_the_lifter(room):
    with torch_threads(2):
        lifter, views = _lifter(room)
        for v in views:
            part = lifter.zeros()
            lifter.lift(*v, into=part)
            share, gap = LOOP.compare(part[0], part[1], *_reference(room, v), W * H)
            assert share == 0 and gap <= LIMITS["sum_gap_max"], (share, gap)
            assert int((part[1] > 0).sum()) > 50


@pytest.mark.parametrize("variant,caught_by", [("truncating_k", "hit_mismatch_share"),
                                               ("bfloat16_control", "sum_gap_max")])
def test_the_check_catches_a_truncating_k_and_the_control(room, variant, caught_by):
    worst = {"hit_mismatch_share": 0.0, "sum_gap_max": 0.0}
    with torch_threads(2):
        lifter, views = _lifter(room, PF.LiftConfig(splat_max_per_tile=8))
        for v in views:
            ref = _reference(room, v)
            if variant == "truncating_k":
                part = lifter.zeros()
                lifter.lift(*v, into=part)
                assert int(part[2]) > 0
                got = part[:2]
            else:
                got = _reference(room, v, map_dtype=torch.bfloat16)
            share, gap = LOOP.compare(*got, *ref, W * H)
            worst = {"hit_mismatch_share": max(worst["hit_mismatch_share"], share),
                     "sum_gap_max": max(worst["sum_gap_max"], gap)}
    assert worst[caught_by] > LIMITS[caught_by], worst


def test_a_view_records_its_spans_and_overflow(room):
    lifter, views = _lifter(room, PF.LiftConfig(splat_max_per_tile=8))
    profiling.reset()
    profiling.enable()
    try:
        with torch_threads(2):
            lifter.lift(*views[0])
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    names = {r.name: r for r in recs}
    assert {"lift.view", "lift.upload", "lift.resize", "lift.projection", "lift.binning",
            "lift.tile_test", "lift.accumulation"} <= set(names)
    assert names["lift.upload"].parent == "lift.view" == names["lift.resize"].parent
    assert names["lift.binning"].counts["overflow"] == int(lifter.overflow) > 0
    assert "staged" not in names["lift.upload"].counts      # the CPU takes the map as it is


def test_the_scene_copies_the_programs_room():
    for n in (1200, 200_000):
        a = SCENE.room_points(np.random.default_rng(0), n)
        b = room_points(np.random.default_rng(0), n)
        assert a.dtype == b.dtype and np.array_equal(a, b)
