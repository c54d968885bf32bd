"""The row test of kernels K1 and K3 (``warp_row_may_hit`` in
segsplat_tpu_torch/ops/blend.py, the plain version of ``row_may_hit`` in
csrc/blend_common.cuh) is exact by construction: it never drops a (row, warp)
pair in which some pixel of the warp passes the sigma and alpha cut, so a blend
that skips the dropped rows equals the blend that reads them, bit for bit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from segsplat_tpu_torch.ops import blend as B
from _torch_port import (BLEND_CASES, blend_case_args, degenerate_case_args,
                         edge_case_args, edge_rows, rows_around_tile)

ALPHA_MIN = np.float32(1.0) / np.float32(255.0)


def _tile_windows(offsets, payload, tx_n, ty_n, K):
    """Every row a tile reads (early-out aside): (win [T, K, W], tiles [T],
    live [T, K])."""
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], K)
    tiles = torch.arange(tx_n * ty_n)
    g = torch.arange(K)
    live = g[None, :] < counts[:, None]
    return payload[off[:-1, None] + g[None, :]], tiles, live


def _hits_and_kept(win, tiles, tx_n, live, footprint=B.WARP_FOOTPRINT):
    """(hit, kept), each [T, G, 8]: some pixel of the warp passes the cut as
    both kernels compute it; the row test keeps the row for the warp."""
    px, py = B._pixel_centres(tiles, tx_n)
    valid = B._block_alpha(win, px, py, live)[-1]
    hit = B._per_warp(valid, footprint)
    kept = B.warp_row_may_hit(win, tiles, tx_n, footprint) & live[..., None]
    return hit, kept


def _assert_exact(hit, kept, what):
    missed = hit & ~kept
    assert not bool(missed.any()), f"{what}: the test drops {int(missed.sum())} warp-rows " \
                                   f"in which a pixel passes the cut"


@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_row_test_never_drops_a_hit_on_sorted_scene_rows(case, ch):
    offsets, payload, bg, tx_n, ty_n, K = blend_case_args(case, "cpu", ch=ch)
    win, tiles, live = _tile_windows(offsets, payload, tx_n, ty_n, K)
    hit, kept = _hits_and_kept(win, tiles, tx_n, live)
    _assert_exact(hit, kept, case)
    read = int(live.sum()) * 8
    # the test drops rows (it is not "keep everything") and keeps no row twice
    assert int(hit.sum()) <= int(kept.sum()) < read


def _check_rows(rows, what, footprint=B.WARP_FOOTPRINT):
    """rows [n, 8] against the tile at (16, 16) of a 3×3-tile frame."""
    win = torch.from_numpy(np.ascontiguousarray(rows, np.float32))[None]
    tiles = torch.tensor([4])
    live = torch.ones(win.shape[:2], dtype=torch.bool)
    hit, kept = _hits_and_kept(win, tiles, 3, live, footprint)
    _assert_exact(hit, kept, what)
    return hit, kept


@pytest.mark.parametrize("footprint", [(8, 4), (16, 2)])
def test_row_test_never_drops_a_hit_on_seeded_rows(footprint):
    rng = np.random.default_rng(0)
    hit, kept = _check_rows(rows_around_tile(rng, 20_000), "seeded rows", footprint)
    assert 0 < int(hit.sum()) <= int(kept.sum()) < kept.numel()


def _sigma_min_on_block(row, x0, y0, fw=8, fh=4):
    """Float64 minimum of sigma over the pixel centres of a block."""
    xs = x0 + 0.5 + np.arange(fw)
    ys = y0 + 0.5 + np.arange(fh)
    dx = row[0] - xs[None, :]
    dy = row[1] - ys[:, None]
    a, b, c = (np.float64(v) for v in row[2:5])
    return float((0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy).min())


def test_row_test_at_the_threshold():
    """Rows whose best pixel sits within a few ulp of the cut: op chosen so
    that op·e^-sigma_min is 1/255 times 1 ± 1e-7 .. 1e-4, elongated conics
    (rho up to 0.9999) included. Every hit must be kept."""
    rng = np.random.default_rng(1)
    rows = rows_around_tile(rng, 6000, spread=14.0, log_scale=(-1.0, 2.5))
    # warp 3's block of tile (16, 16): x 24..31, y 20..23 (8×4 footprint)
    bx, by = 16 + B._warp_origins()[0][3].item(), 16 + B._warp_origins()[1][3].item()
    eps = np.exp(rng.uniform(np.log(1e-7), np.log(1e-4), len(rows))) * rng.choice([-1, 1],
                                                                                len(rows))
    for i, r in enumerate(rows):
        if i % 3 == 0:      # nearly degenerate: rho close to 1
            rho = 1 - 10 ** rng.uniform(-4, -1)
            r[3] = np.float32(np.sign(r[3] or 1) * rho * np.sqrt(r[2] * r[4]))
        s = _sigma_min_on_block(r.astype(np.float64), bx, by)
        r[5] = np.float32(ALPHA_MIN * np.exp(min(s, 60.0)) * (1 + eps[i]))
    rows = rows[np.isfinite(rows).all(1) & (rows[:, 5] > 0) & (rows[:, 5] < 1e20)]
    hit, _ = _check_rows(rows, "threshold rows")
    assert int(hit[..., 3].sum()) > 100       # many rows pass at exactly one pixel or so


def test_row_test_never_drops_a_hit_on_edge_rows():
    rows = edge_rows()
    hit, kept = _check_rows(rows, "edge rows")
    r = torch.from_numpy(rows)
    op = r[:, 5]
    # below 1/255 nothing is kept; non-PD conics are always kept
    assert not bool(kept[0][op < float(ALPHA_MIN)].any())
    ca, cb, cc = r[:, 2], r[:, 3], r[:, 4]
    not_pd = ~((ca > 0) & (ca * cc - cb * cb > 0)) & (op >= float(ALPHA_MIN))
    assert bool(kept[0][not_pd].all())
    assert bool(hit.any()) and not bool(kept.all())


def test_row_test_keeps_non_finite_rows():
    """A non-finite opacity passes the kernels' cut wherever sigma ≥ 0
    (fminf(0.999, NaN) is 0.999), so the test keeps such rows."""
    rows = np.array([[24, 24, 0.5, 0, 0.5, np.nan, 0, 0], [24, 24, 0.5, 0, 0.5, np.inf, 0, 0],
                     [24, 24, np.nan, 0, 0.5, 0.5, 0, 0], [24, 24, 0.5, np.inf, 0.5, 0.5, 0, 0],
                     [400, 400, 0.5, 0, 0.5, np.nan, 0, 0]], np.float32)
    win = torch.from_numpy(rows)[None]
    kept = B.warp_row_may_hit(win, torch.tensor([4]), 3)
    assert bool(kept.all())


def _culled_block_alpha(tx_n):
    """``_block_alpha`` that zeroes the rows the test drops, per warp."""
    orig = B._block_alpha
    fw, fh = B.WARP_FOOTPRINT
    pid = torch.arange(B.PX)
    warp_of = (pid % B.TILE) // fw + (B.TILE // fw) * ((pid // B.TILE) // fh)

    def culled(win, px, py, live):
        dx, dy, ex, raw, a, valid = orig(win, px, py, live)
        tiles = ((py[:, 0, 0] - 0.5).long() // B.TILE) * tx_n + (px[:, 0, 0] - 0.5).long() // B.TILE
        keep = B.warp_row_may_hit(win, tiles, tx_n)[..., warp_of]          # [C, G, PX]
        return dx, dy, ex, raw, torch.where(keep, a, 0.0), valid & keep

    return culled


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_blend_with_culled_rows_is_bit_identical(case, monkeypatch):
    args = blend_case_args(case, "cpu", ch=19)
    ref = B.blend_tiles_plain(*args)
    monkeypatch.setattr(B, "_block_alpha", _culled_block_alpha(args[3]))
    got = B.blend_tiles_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_packed_blend_with_culled_rows_is_bit_identical(monkeypatch):
    args = blend_case_args("k384_opaque_early_out", "cpu", ch=32, packed=True)
    ref = B.blend_tiles_packed_plain(*args)
    monkeypatch.setattr(B, "_block_alpha", _culled_block_alpha(args[3]))
    got = B.blend_tiles_packed_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", ["k384_three_blocks_carry", "k384_opaque_early_out",
                                  "wide_faint_k256"])
def test_warp_row_counters(case):
    """read counts 8 warp-rows per row the blend reads (early-out included);
    hit ≤ kept ≤ read; K3 counts couples."""
    args = blend_case_args(case, "cpu", ch=32)
    _, _, rows_read, _, _ = B.blend_tiles_plain_with_work(*args)
    work = B.blend_tiles_warp_rows(*args)
    assert work["read"] == 8 * rows_read
    assert 0 < work["hit"] <= work["kept"] <= work["read"]
    pargs = blend_case_args(case, "cpu", ch=32, packed=True)
    _, _, pairs_read, _, _ = B.blend_tiles_packed_plain_with_work(*pargs)
    pwork = B.blend_tiles_packed_warp_rows(*pargs)
    assert pwork["read"] <= 8 * pairs_read < 2 * pwork["read"] + 8 * len(pargs[0])
    assert 0 < pwork["hit"] <= pwork["kept"] <= pwork["read"]


def test_warp_rows_on_degenerate_tiles():
    """Tiles with count 0 read nothing; a tile past its K cap reads K rows."""
    offsets, payload, bg, tx_n, ty_n, K = degenerate_case_args("cpu", ch=19)
    work = B.blend_tiles_warp_rows(offsets, payload, bg, tx_n, ty_n, K)
    counts = np.minimum(np.diff(offsets.numpy()), K)
    assert work["read"] <= 8 * counts.sum()
    win, tiles, live = _tile_windows(offsets, payload, tx_n, ty_n, K)
    hit, kept = _hits_and_kept(win, tiles, tx_n, live)
    _assert_exact(hit, kept, "degenerate tiles")
    assert work["hit"] <= work["kept"] <= int(kept.sum())


@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
def test_row_test_on_edge_tiles(ch):
    """The edge tiles of the card tests (count 0, one row, past K, partial
    chunks, the edge rows about every tile): no hit dropped, and skipping the
    dropped rows blends the same bits, for K1 and K3."""
    args = edge_case_args("cpu", ch=ch)
    offsets, payload, bg, tx_n, ty_n, K = args
    win, tiles, live = _tile_windows(offsets, payload, tx_n, ty_n, K)
    hit, kept = _hits_and_kept(win, tiles, tx_n, live)
    _assert_exact(hit, kept, "edge tiles")
    assert int(hit.sum()) < int(kept.sum()) < int(live.sum()) * 8
    pargs = (offsets, B.pack_payload(payload[:-K], K), bg, tx_n, ty_n, K)
    ref, pref = B.blend_tiles_plain(*args), B.blend_tiles_packed_plain(*pargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B, "_block_alpha", _culled_block_alpha(tx_n))
        got, pgot = B.blend_tiles_plain(*args), B.blend_tiles_packed_plain(*pargs)
    for g, r in zip(got + pgot, ref + pref):
        assert torch.equal(g, r)


def test_k1_variants_follow_the_kernel_source():
    """scripts/k1_variants.py finds its anchors in csrc/blend_fwd.cu and
    csrc/blend_common.cuh: each variant is the kernel with the header pasted in
    and its own edit; the kernels' footprint is the plain counter's."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import k1_variants as KV

    src, header = KV.SOURCE.read_text(), KV.HEADER.read_text()
    out = KV.variants(src, header)
    assert sorted(out) == ["all_rows", "b1", "b4", "bbox", "mb2_32", "mb3_19", "strip"]
    assert len({src.replace(KV.INCLUDE, header), *out.values()}) == 8
    assert not any(KV.INCLUDE in text for text in out.values())
    assert "row_may_hit(rows[" not in out["all_rows"]
    assert out["bbox"].count("row_may_hit_bbox(rows[") == 2
    fw, fh = B.WARP_FOOTPRINT
    assert f"constexpr int kFootW = {fw};" in header and fw * fh == 32
