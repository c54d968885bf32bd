"""The feature lift on the card against the same port functions on the CPU, on
the small scenes of tests/test_torch_lift*.py: hit images of the DDA and the
splat on ≥ 99.9 % of pixels, sums at rtol/atol 1e-5, the resize at 1e-5, and
the same bits from two runs of each accumulation on the card. Imports no JAX,
so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lift_cuda.py

One case lifts one view of the benchmark's lift cell at full size
(``benchmark/configs/officescene-room-lift.json``: 876×584 rays, 512
channels, 91 520 voxels) through ``ViewLifter`` and holds it against the
benchmark's plain reference within the cell's limits, with no slot
truncated. The staged upload (``MapStage``) gives the bits of the map
copied as it is, view after view through reused buffers, whatever the
caller writes into its array once ``lift`` has returned; and the view's
geometry half waits for nothing on the card.

Without a card every case skips."""

import numpy as np
import pytest
import torch

# by their bare names: pytest puts tests/ on sys.path
from _torch_port import LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy, occupied_voxels
from oracles import make_test_scene
from segsplat_tpu_torch.ops import lift as PL
from segsplat_tpu_torch.ops import lift_splat as PS
from segsplat_tpu_torch.ops.voxelize import segment_sum
from segsplat_tpu_torch.pipeline.lift_features import resize_features

W, H = 64, 48


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _on(dev, *xs):
    return [torch.as_tensor(np.array(x), device=dev) for x in xs]


def _dda(dev, view):
    occ = lift_occupancy(np.random.default_rng(0))
    intr = np.array([70.0, 70.0, W / 2, H / 2], np.float32)
    inc = np.float32(LIFT_VS * 0.5)
    steps = PL.default_max_steps(W, H, 70.0, 70.0, 0.05, 8.0, float(inc))
    o, c2w, k, org, vs, i = _on(dev, occ, lift_camera(view, 3), intr, LIFT_ORIGIN,
                                np.float32(LIFT_VS), inc)
    return PL.first_hit_voxels(o, c2w, k, org, vs, 0.05, 8.0, i, W, H, steps)


def _splat_args(dev, view, scale=1.0):
    centers, ids = occupied_voxels(lift_occupancy(np.random.default_rng(0)), LIFT_VS,
                                   LIFT_ORIGIN)
    intr = np.array([70.0, 70.0, W / 2, H / 2], np.float32)
    c, i, c2w, k, vs, inc = _on(dev, centers, ids, lift_camera(view, 3, scale), intr,
                                np.float32(LIFT_VS), np.float32(LIFT_VS * 0.5))
    return (c, i, c2w, k, vs, 0.05, 8.0, inc), int(ids.max()) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("view", [0, 1, 2])
def test_dda_on_card_matches_cpu(view):
    _need_card()
    got, ref = _dda("cuda", view).cpu(), _dda("cpu", view)
    assert (ref > 0).float().mean() > 0.3
    assert (got == ref).float().mean() >= 0.999


@pytest.mark.cuda
def test_dda_on_card_on_the_oracle_scene():
    _need_card()
    occ, c2w, intr, origin, vs, w, h = make_test_scene(np.random.default_rng(3))
    steps = PL.default_max_steps(w, h, intr[0], intr[1], 0.01, 3.0, vs * 0.5)
    outs = []
    for dev in ("cuda", "cpu"):
        o, c, k, org, v, inc = _on(dev, occ, c2w, intr, origin, np.float32(vs),
                                   np.float32(vs * 0.5))
        outs.append(PL.first_hit_voxels(o, c, k, org, v, 0.01, 3.0, inc, w, h, steps).cpu())
    assert (outs[0] == outs[1]).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("view,scale", [(0, 1.0), (1, 1.0), (2, 0.6)])
def test_splat_lift_on_card_matches_cpu_and_repeats_its_bits(view, scale):
    _need_card()
    C = 32
    feats = np.random.default_rng(view).random((H, W, C)).astype(np.float32)
    kw = dict(max_tiles_per_axis=6, max_per_tile=128, tile_chunk=8)
    out = {}
    for dev in ("cuda", "cpu"):
        args, num_ids = _splat_args(dev, view, scale)
        hits = PS.first_hit_voxels_splat(*args, W, H, **kw)
        f = torch.as_tensor(feats, device=dev)
        out[dev] = (hits.cpu(),) + tuple(PS.lift_view_splat(*args, f, num_ids, W, H, **kw))
        if dev == "cuda":
            again = PS.lift_view_splat(*args, f, num_ids, W, H, **kw)
            assert torch.equal(again[0], out[dev][1]) and torch.equal(again[1], out[dev][2])
    (gh, gs, gc, gof), (rh, rs, rc, rof) = out["cuda"], out["cpu"]
    assert (gh == rh).float().mean() >= 0.999 and int(gof) == int(rof)
    if torch.equal(gh, rh):
        torch.testing.assert_close(gc.cpu(), rc, rtol=0, atol=0)
        torch.testing.assert_close(gs.cpu(), rs, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_accumulations_on_card_repeat_their_bits():
    _need_card()
    rng = np.random.default_rng(5)
    vals = torch.as_tensor(rng.normal(size=(200_000, 64)).astype(np.float32), device="cuda")
    ids = torch.as_tensor(rng.integers(0, 3000, 200_000), device="cuda")
    a, b = segment_sum(vals, ids, 3000), segment_sum(vals, ids, 3000)
    assert torch.equal(a, b)
    ref = segment_sum(vals.cpu(), ids.cpu(), 3000)
    torch.testing.assert_close(a.cpu(), ref, rtol=1e-5, atol=1e-4)
    hits = torch.as_tensor(rng.integers(0, 3000, (H, W)).astype(np.int32), device="cuda")
    f = vals[:H * W].reshape(H, W, 64)
    s1, c1 = PL.scatter_features(f, hits, 3000)
    s2, c2 = PL.scatter_features(f, hits, 3000)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((146, 219), (292, 438)), ((60, 90), (23, 31))])
def test_resize_on_card_matches_cpu(src, dst):
    _need_card()
    x = torch.as_tensor(np.random.default_rng(6).random((16,) + src).astype(np.float16))
    got = resize_features(x.cuda(), *dst).cpu()
    torch.testing.assert_close(got, resize_features(x, *dst), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_a_full_size_view_of_the_lift_cell_against_the_reference():
    _need_card()
    from benchmark.harness.cell import load_cell
    from benchmark.reference import lift as reference
    from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, ViewLifter

    cell = load_cell("lift-officescene")
    cfg, lim = cell.config, cell.traffic["limits"]
    s = cell.scene_module().draw(dict(cfg, maps=1), 2 ** 31 + 5, "cuda")
    w, h, vs = cfg["width"], cfg["height"], cfg["cell_size"]
    lifter = ViewLifter(s["centers"], vs, s["origin"],
                        tuple(int(v) for v in s["cells"].max(axis=0) + 1), cfg["channels"],
                        h, w, LiftConfig(depth_min=cfg["depth_min"], depth_max=cfg["depth_max"],
                                         ray_increment_factor=cfg["ray_increment_factor"],
                                         splat_max_tiles_per_axis=cfg["max_tiles_per_axis"],
                                         splat_max_per_tile=cfg["max_per_tile"]), "cuda")
    # a view across the corridor at the clutter, where the tiles run deepest
    fmap, c2w = s["maps"][0], s["c2w"][138]
    part = lifter.zeros()
    lifter.lift(fmap, c2w, s["intrinsics"], into=part)
    dev = torch.device("cuda")
    hits = reference.march(reference.occupancy(torch.as_tensor(s["cells"], device=dev)),
                           torch.as_tensor(s["origin"], device=dev), vs,
                           torch.as_tensor(c2w, device=dev), s["intrinsics"], w, h,
                           cfg["depth_min"], cfg["depth_max"], vs * cfg["ray_increment_factor"])
    ref = reference.lift_view(reference.resize(torch.from_numpy(fmap).to(dev), h, w), hits,
                              len(s["cells"]) + 1)
    share, gap = cell.loop_module().compare(part[0], part[1], *ref, w * h)
    assert int(part[2]) == 0 and int((part[1] > 0).sum()) > 5000
    assert share <= lim["hit_mismatch_share"] and gap <= lim["sum_gap_max"], (share, gap)


ROOM = dict(points=1200, layout_seed=0, density_eps=0.08, density_min_neighbors=0,
            cell_size=0.3, views=10, native_w=128, native_h=96, fx_native=100.0,
            downsample=0.5)


def _room_lifter(device, channels):
    from benchmark.harness.cell import BENCH_DIR, load_module
    from segsplat_tpu_torch.pipeline.lift_features import LiftConfig, ViewLifter

    scene = load_module(BENCH_DIR / "scenes" / "room_lift.py")
    cells, origin, centers = scene.voxels(ROOM)
    c2w, intr = scene.cameras(ROOM)
    lifter = ViewLifter(centers, ROOM["cell_size"], origin, tuple(cells.max(0) + 1),
                        channels, H, W, LiftConfig(splat_max_per_tile=64), device)
    return lifter, c2w, intr


@pytest.mark.cuda
def test_the_staged_upload_gives_the_bits_of_the_map_copied_as_it_is():
    """Ten views cycle three fp16 maps through one caller array, overwritten
    with noise once each ``lift`` returns, then a float32 map of another
    shape and an fp16 map again: every view's sums, counts and overflow
    equal the map copied to the card as it is, resized and lifted by
    ``lift_view_splat``; ``lift.upload`` counts ``staged`` once a view on the
    card and never on the CPU."""
    _need_card()
    from segsplat_tpu_torch.ops.lift_splat import lift_view_splat
    from segsplat_tpu_torch.utils import profiling

    C = 64
    lifter, c2w, intr = _room_lifter("cuda", C)
    rng = np.random.default_rng(8)
    maps = [rng.standard_normal((C, 360, 540)).astype(np.float16) for _ in range(3)]
    # then a map of another shape and dtype, and the first shape again: the
    # stage's device buffer is made anew twice
    other = rng.standard_normal((C, 200, 300)).astype(np.float32)
    callers = [np.empty_like(maps[0])] * 10 + [other.copy(), np.empty_like(maps[0])]
    cfg, f32 = lifter.cfg, dict(dtype=torch.float32, device="cuda")
    profiling.reset()
    profiling.enable()
    try:
        for v, caller in enumerate(callers):
            m = other if v == 10 else maps[v % 3]
            caller[...] = m
            got = lifter.zeros()
            lifter.lift(caller, c2w[v % len(c2w)], intr, into=got)
            caller[...] = rng.standard_normal(caller.shape).astype(caller.dtype)
            fmap = resize_features(torch.from_numpy(m).cuda(), H, W)
            ref = lift_view_splat(lifter.snap_centers, lifter.snap_ids,
                                  torch.as_tensor(c2w[v % len(c2w)], **f32),
                                  torch.as_tensor(intr, **f32),
                                  lifter.vs_t, cfg.depth_min, cfg.depth_max, lifter.inc_t,
                                  fmap.permute(1, 2, 0), lifter.num_ids, W, H,
                                  max_tiles_per_axis=cfg.splat_max_tiles_per_axis,
                                  max_per_tile=cfg.splat_max_per_tile)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), v
            assert int(got[2]) == int(ref[2]) and int(got[1].sum()) > 0
        uploads = [r for r in profiling.records() if r.name == "lift.upload"]
        assert len(uploads) == 12 and all(r.counts.get("staged") == 1 for r in uploads)
        profiling.reset()
        cpu, _, _ = _room_lifter("cpu", C)
        cpu.lift(maps[0], c2w[0], intr)
        uploads = [r for r in profiling.records() if r.name == "lift.upload"]
        assert len(uploads) == 1 and "staged" not in uploads[0].counts
    finally:
        profiling.disable()
        profiling.reset()


@pytest.mark.cuda
def test_the_view_geometry_waits_for_nothing_on_the_card():
    """The camera's tensors and ``splat_geometry`` make no synchronising call
    (``torch.cuda.set_sync_debug_mode("error")``), so the map's upload
    starts while the card runs them."""
    _need_card()
    from segsplat_tpu_torch.ops.lift_splat import splat_geometry

    lifter, c2w, intr = _room_lifter("cuda", 8)
    cfg = lifter.cfg
    for _ in range(2):                     # the second time with warm caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            c, k = lifter._camera(c2w[1]), lifter._camera(intr)
            geo = splat_geometry(lifter.snap_centers, lifter.snap_ids, c, k, lifter.vs_t,
                                 cfg.depth_min, cfg.depth_max, lifter.inc_t, W, H,
                                 max_tiles_per_axis=cfg.splat_max_tiles_per_axis,
                                 max_per_tile=cfg.splat_max_per_tile)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.cat([h for _, _, h, _ in geo["chunks"]]).any())
