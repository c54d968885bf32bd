"""Kernels K1 (segsplat_tpu_torch/csrc/blend_fwd.cu), K2 (csrc/blend_bwd.cu) and
K3 (csrc/blend_packed.cu) against their plain versions on the card, K1 and
K2 on every blend case at the training raster's 19 channels, the semantic
path's 32, the one-pass render's 51 and at 3, 8, 23 and 120; K3 at 8, 19,
23, 32, 51 and 56, and against K1 on the same scene; K1 and K3 on edge tiles (count 0, one row, count > K, partial last chunks, the row
test's edge rows); every width, K1 and K2 at 1..120 and K3 at 1..56, on one
case; rasterize on K1 and K2 against the dense blend at K = 200, no multiple of
128, forward and gradients, at 3 to 120 channels; K1's indexed variant (the
no-grad render path) against K1 on the gathered payload, bit for bit, on the
benchmark's two view scenes. chip_smoke.py phase 2 runs this file.
Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_blend_cuda.py

(tests/conftest.py imports JAX, which that machine does not have.) Without a
card every case skips."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from segsplat_tpu_torch.ops import blend as B
from segsplat_tpu_torch.ops.rasterize import rasterize
from segsplat_tpu_torch.parallel.render import rasterize_strip
# by its bare name: pytest puts tests/ on sys.path, and a machine may have an
# installed package named `tests` that hides this directory's
from _torch_port import (BLEND_CASES, DEGENERATE_K, K_ODD, PACKED_CASES, PACKED_G,
                         assert_case_exercised, blend_case_args, degenerate_case_args,
                         edge_case_args, odd_k_raster, owned_rows)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


# the main paths' widths, and widths run padded (3 → 4, 23 → 24), the GT
# sweep's 8 and 24 and the widest
CASE_CHANNELS = sorted(set(B.KERNEL_CHANNELS) | {3, 8, 23, 120})


@pytest.mark.cuda
@pytest.mark.parametrize("ch", CASE_CHANNELS)
@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_kernel_matches_plain_version_on_card(case, ch):
    _need_card()
    args = blend_case_args(case, "cuda", ch=ch)
    before = B.blend_tiles.launches
    got = B.blend_tiles(*args)
    ref_img, ref_alpha, rows_read, _, _ = B.blend_tiles_plain_with_work(*args)
    torch.cuda.synchronize()
    assert B.blend_tiles.launches == before + 1
    for g, r in zip(got, (ref_img, ref_alpha)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    assert_case_exercised(case, args[0].cpu().numpy(), args[-1], rows_read)


@pytest.mark.cuda
@pytest.mark.parametrize("ch", CASE_CHANNELS)
@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_backward_kernel_matches_plain_version_on_card(case, ch):
    _need_card()
    offsets, payload, bg, tx_n, ty_n, K = blend_case_args(case, "cuda", ch=ch)
    img, alpha = B.blend_tiles_plain(offsets, payload, bg, tx_n, ty_n, K)
    gen = torch.Generator("cuda").manual_seed(ch)
    g_img = torch.randn(img.shape, generator=gen, device="cuda")
    g_alpha = torch.randn(alpha.shape, generator=gen, device="cuda")
    args = (offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K)
    before = B.blend_tiles_bwd.launches
    got = B.blend_tiles_bwd(*args)
    ref = B.blend_tiles_bwd_plain(*args)
    torch.cuda.synchronize()
    assert B.blend_tiles_bwd.launches == before + 1
    for g, r in zip(got, ref):
        r = r.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), r, rtol=5e-3,
                                   atol=2e-4 * (np.abs(r).max() + 1e-6))
    owned = owned_rows(offsets.cpu().numpy(), K, payload.shape[0])
    assert not got[0].cpu().numpy()[~owned].any(), "rows no tile owns must stay 0"


@pytest.mark.cuda
@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
def test_backward_kernel_on_degenerate_tiles_on_card(ch):
    """Tiles with count 0 write nothing, and a tile whose count exceeds K leaves
    the rows past its cap at exactly 0."""
    _need_card()
    offsets, payload, bg, tx_n, ty_n, K = degenerate_case_args("cuda", ch=ch)
    img, alpha = B.blend_tiles_plain(offsets, payload, bg, tx_n, ty_n, K)
    gen = torch.Generator("cuda").manual_seed(ch)
    args = (offsets, payload, bg, img, alpha, torch.randn(img.shape, generator=gen,
                                                          device="cuda"),
            torch.randn(alpha.shape, generator=gen, device="cuda"), tx_n, ty_n, K)
    got = B.blend_tiles_bwd(*args)
    ref = B.blend_tiles_bwd_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), r, rtol=5e-3,
                                   atol=2e-4 * (np.abs(r).max() + 1e-6))
    off = offsets.cpu().numpy()
    d_pay = got[0].cpu().numpy()
    owned = owned_rows(off, DEGENERATE_K, payload.shape[0])
    assert not d_pay[off[1] + DEGENERATE_K:off[2]].any(), "rows past the K cap must stay 0"
    assert not d_pay[~owned].any() and np.abs(d_pay[owned]).max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ch", sorted(set(B.KERNEL_CHANNELS) | {8, 23, B.PACKED_MAX_CH}))
@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_kernel_matches_plain_version_and_k1_on_card(case, ch):
    """K3 against its plain version at 1e-4, and against K1 on the same scene
    at 1e-4 + 2·SAT_EPS·max(|colour|, |bg|) (its 128-pair early-out may stop a
    saturated tile one block before K1's 256-row one); at the main paths'
    widths and at 8, 23 (run padded to 24) and 56, K3's widest."""
    _need_card()
    args = blend_case_args(case, "cuda", ch=ch, packed=True)
    before = B.blend_tiles_packed.launches
    got = B.blend_tiles_packed(*args)
    ref_img, ref_alpha, rows_read, _, _ = B.blend_tiles_packed_plain_with_work(*args)
    torch.cuda.synchronize()
    assert B.blend_tiles_packed.launches == before + 1
    for g, r in zip(got, (ref_img, ref_alpha)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    assert_case_exercised(case, args[0].cpu().numpy(), args[-1], rows_read, g=PACKED_G)

    dense = blend_case_args(case, "cuda", ch=ch)
    k1 = B.blend_tiles(*dense)
    colours = dense[1][:, B.GEOM:B.GEOM + ch]
    atol = 1e-4 + 2 * B.SAT_EPS * max(float(colours.abs().max()), float(dense[2].abs().max()))
    for g, r in zip(got, k1):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_forward_kernels_on_edge_tiles_on_card(kernel, ch):
    """K1 or K3 against its plain version at 1e-4 on the edge tiles
    (tests/_torch_port.py edge_case_args) and on the degenerate ones: tiles
    with count 0, one row, count > K, partial last chunks, and rows at the
    edges of the row test (opacity at 1/255 and at the clamp, non-PD conics,
    mu on block edges, splats wider than the tile, mu far outside)."""
    _need_card()
    for args in (edge_case_args("cuda", ch=ch), degenerate_case_args("cuda", ch=ch)):
        if kernel == "k3":
            offsets, payload, bg, tx_n, ty_n, K = args
            args = (offsets, B.pack_payload(payload[:-K], K), bg, tx_n, ty_n, K)
            fn, plain, counter = (B.blend_tiles_packed, B.blend_tiles_packed_plain,
                                  B.blend_tiles_packed_warp_rows)
        else:
            fn, plain, counter = B.blend_tiles, B.blend_tiles_plain, B.blend_tiles_warp_rows
        before = fn.launches
        got = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        work = counter(*args)
        assert 0 < work["hit"] <= work["kept"] <= work["read"]


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [3, 8, 19, 23, 32, 120])
def test_kernels_match_dense_blend_at_odd_k_on_card(ch):
    """K = 200, no multiple of 128: rasterize on the kernels (K1 forward, K2
    backward, one launch each) against the dense blend, forward at 1e-4,
    gradients at rtol 5e-3, atol 2e-4·max|ref|; at the main paths' widths and
    at widths run padded (3 → 4, 23 → 24) or the widest."""
    _need_card()
    before = (B.blend_tiles.launches, B.blend_tiles_bwd.launches)
    img, alpha, over, grads = odd_k_raster("cuda", "cuda", ch)
    torch.cuda.synchronize()
    assert (B.blend_tiles.launches, B.blend_tiles_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    d_img, d_alpha, d_over, d_grads = odd_k_raster("cuda", "dense", ch)
    assert int(over) == int(d_over) > 0, f"no tile is cut at K={K_ODD}"
    torch.testing.assert_close(img, d_img, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alpha, d_alpha, rtol=1e-4, atol=1e-4)
    for name, r in d_grads.items():
        atol = 2e-4 * float(r.abs().max())
        torch.testing.assert_close(grads[name], r, rtol=5e-3, atol=atol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("ch", (1, 3, 8, 23, 60, 96, 120))
@pytest.mark.parametrize("case", ("k200_partial_block", "k384_three_blocks_carry"))
def test_kernels_at_padded_widths_on_card(case, ch):
    """K1 and K2 at channel counts no kernel is built for, run padded to the
    next width of B.KERNEL_WIDTHS (K3 up to 56 of B.PACKED_WIDTHS), against
    their plain versions at the caller's CH."""
    _need_card()
    args = blend_case_args(case, "cuda", ch=ch)
    before = (B.blend_tiles.launches, B.blend_tiles_bwd.launches)
    img, alpha = B.blend_tiles(*args)
    ref_img, ref_alpha = B.blend_tiles_plain(*args)
    assert img.shape == ref_img.shape
    torch.testing.assert_close(img, ref_img, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alpha, ref_alpha, rtol=1e-4, atol=1e-4)
    gen = torch.Generator("cuda").manual_seed(ch)
    bargs = (args[0], args[1], args[2], ref_img, ref_alpha,
             torch.randn(ref_img.shape, generator=gen, device="cuda"),
             torch.randn(ref_alpha.shape, generator=gen, device="cuda"), *args[3:])
    got, ref = B.blend_tiles_bwd(*bargs), B.blend_tiles_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert (B.blend_tiles.launches, B.blend_tiles_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=5e-3, atol=2e-4 * float(r.abs().max()))
    if ch <= B.PACKED_MAX_CH:
        pargs = blend_case_args(case, "cuda", ch=ch, packed=True)
        for g, r in zip(B.blend_tiles_packed(*pargs), B.blend_tiles_packed_plain(*pargs)):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


WIDTH_SWEEP_CASE = "k128_one_block"


@pytest.mark.cuda
def test_kernels_at_every_width_on_card():
    """K1 and K2 at every CH in 1..MAX_CH, and K3 at every CH in
    1..PACKED_MAX_CH, on one case against their plain versions: K1 and K3 at
    1e-4, K2 at rtol 5e-3, atol 2e-4·max|ref|, with the rows no tile owns
    exactly 0."""
    _need_card()
    gen = torch.Generator("cuda").manual_seed(10)
    for ch in range(1, B.MAX_CH + 1):
        args = blend_case_args(WIDTH_SWEEP_CASE, "cuda", ch=ch)
        offsets, payload, bg, tx_n, ty_n, K = args
        img, alpha = B.blend_tiles_plain(*args)
        for g, r in zip(B.blend_tiles(*args), (img, alpha)):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"K1 CH={ch}: {m}")
        bargs = (offsets, payload, bg, img, alpha,
                 torch.randn(img.shape, generator=gen, device="cuda"),
                 torch.randn(alpha.shape, generator=gen, device="cuda"), tx_n, ty_n, K)
        got = B.blend_tiles_bwd(*bargs)
        for g, r in zip(got, B.blend_tiles_bwd_plain(*bargs)):
            torch.testing.assert_close(g, r, rtol=5e-3, atol=2e-4 * float(r.abs().max()),
                                       msg=lambda m: f"K2 CH={ch}: {m}")
        owned = owned_rows(offsets.cpu().numpy(), K, payload.shape[0])
        assert not got[0].cpu().numpy()[~owned].any(), f"K2 CH={ch}: a row no tile owns"
        if ch <= B.PACKED_MAX_CH:
            pargs = blend_case_args(WIDTH_SWEEP_CASE, "cuda", ch=ch, packed=True)
            for g, r in zip(B.blend_tiles_packed(*pargs), B.blend_tiles_packed_plain(*pargs)):
                torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4,
                                           msg=lambda m: f"K3 CH={ch}: {m}")


# ── K1's indexed variant against K1 on the gathered payload ──

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"


def _view_scene(config: str, seed: int, ch=None) -> dict:
    """The benchmark configuration's scene (``benchmark/scenes``) on the card,
    as rasterize's inputs; ``ch`` logit channels in place of the config's."""
    import importlib

    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    if ch is not None:
        cfg["channels"] = ch
    s = importlib.import_module(f"benchmark.scenes.{cfg['scene']}").draw(cfg, seed, "cuda")
    return dict(xyz=s["xyz"], scales=torch.exp(s["log_scales"]), quats=s["quats"],
                opac=torch.sigmoid(s["opacity_logit"])[:, 0], colors=s["logits"],
                bg=torch.zeros(s["logits"].shape[1], device="cuda"),
                m=cfg["max_tiles_per_axis"], K=cfg["max_per_tile"])


def _both_paths(sc: dict, width: int = 1920, height: int = 1080, pair_cap=None, strip=None):
    """rasterize under no_grad (K1's indexed variant, one launch of its own
    counter, none of K1's) and with the colours needing grad (the gathered
    payload through K1's op, one launch of K1's counter), each synchronised;
    the viewer's camera (fov 1.2 × 0.75 rad) at the origin. Returns
    (indexed, gathered) outputs."""
    vm = torch.eye(4, device="cuda")
    fx, fy = width / (2 * math.tan(0.6)), height / (2 * math.tan(0.375))

    def call(colors):
        args = (sc["xyz"], sc["scales"], sc["quats"], sc["opac"], colors, vm,
                fx, fy, width / 2, height / 2, width, height)
        kw = dict(bg=sc["bg"], max_tiles_per_axis=sc["m"], max_per_tile=sc["K"],
                  pair_cap=pair_cap)
        return rasterize_strip(*strip, *args, **kw) if strip else rasterize(*args, **kw)

    counts = lambda: (B.blend_tiles_indexed.launches, B.blend_tiles.launches)
    before = counts()
    with torch.no_grad():
        got = call(sc["colors"])
    torch.cuda.synchronize()
    mid = counts()
    ref = call(sc["colors"].detach().clone().requires_grad_(True))
    torch.cuda.synchronize()
    assert (mid[0] - before[0], mid[1] - before[1]) == (1, 0)
    assert (counts()[0] - mid[0], counts()[1] - mid[1]) == (0, 1)
    assert ref["image"].requires_grad and not got["image"].requires_grad
    return got, ref


def _assert_same_bits(got, ref):
    for key in ("image", "alpha", "num_pairs", "tile_overflow"):
        assert torch.equal(got[key], ref[key].detach()), key


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 0.5])
def test_indexed_k1_matches_k1_on_the_clustered_scene_on_card(cap):
    """officescene-clustered (m = 6, K = 512, tiles ~58 000 deep, three
    quarters of the pairs past K), without a pair cap and with one at half
    the frame's pairs."""
    _need_card()
    sc = _view_scene("officescene-clustered", 3300000011)
    pair_cap = None
    if cap is not None:
        with torch.no_grad():
            pairs = int(rasterize(sc["xyz"], sc["scales"], sc["quats"], sc["opac"],
                                  sc["colors"], torch.eye(4, device="cuda"),
                                  1920 / (2 * math.tan(0.6)), 1080 / (2 * math.tan(0.375)),
                                  960, 540, 1920, 1080, bg=sc["bg"], max_tiles_per_axis=6,
                                  max_per_tile=512)["num_pairs"])
        pair_cap = int(pairs * cap)
    got, ref = _both_paths(sc, pair_cap=pair_cap)
    _assert_same_bits(got, ref)
    assert int(ref["tile_overflow"]) > 0, "no tile is deeper than K"


@pytest.mark.cuda
@pytest.mark.parametrize("ch", (8, 19, 24, 32, 51))
def test_indexed_k1_matches_k1_on_the_box_scene_on_card(ch):
    """officescene-semantic32's scene (m = 3, K = 256) at the widths the
    paths render: the GT sweep's 8 and 24, training's 19, the semantic 32 and
    the one-pass 51."""
    _need_card()
    _assert_same_bits(*_both_paths(_view_scene("officescene-semantic32", 3300000007, ch)))


@pytest.mark.cuda
def test_indexed_k1_matches_k1_on_a_strip_on_card():
    """Strip 1 of 4 of a 1920 × 1024 frame (tile_row0 = 16) of the box scene."""
    _need_card()
    sc = _view_scene("officescene-semantic32", 3300000009)
    _assert_same_bits(*_both_paths(sc, width=1920, height=1024, strip=(1, 4)))
