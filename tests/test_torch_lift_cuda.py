"""The feature lift on the card against the same port functions on the CPU, on
the small scenes of tests/test_torch_lift*.py: hit images of the DDA and the
splat on ≥ 99.9 % of pixels, sums at rtol/atol 1e-5, the resize at 1e-5, and
the same bits from two runs of each accumulation on the card. Imports no JAX,
so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lift_cuda.py

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
