"""Kernels K1 (segsplat_tpu_torch/csrc/blend_fwd.cu), K2 (csrc/blend_bwd.cu) and
K3 (csrc/blend_packed.cu) against their plain versions on the card, at the
training raster's 19 channels, the semantic path's 32 and the one-pass
render's 51; K3 against K1 on the same scene; K1 and K3 on edge tiles (count 0,
one row, count > K, partial last chunks, the row test's edge rows). Imports no JAX, so it runs
where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_blend_cuda.py

(tests/conftest.py imports JAX, which that machine does not have.) Without a
card every case skips."""

import numpy as np
import pytest
import torch

from segsplat_tpu_torch.ops import blend as B
# by its bare name: pytest puts tests/ on sys.path, and a machine may have an
# installed package named `tests` that hides this directory's
from _torch_port import (BLEND_CASES, DEGENERATE_K, PACKED_CASES, PACKED_G,
                         assert_case_exercised, blend_case_args, degenerate_case_args,
                         edge_case_args, owned_rows)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
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
@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
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
@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_kernel_matches_plain_version_and_k1_on_card(case, ch):
    """K3 against its plain version at 1e-4, and against K1 on the same scene
    at 1e-4 + 2·SAT_EPS·max(|colour|, |bg|) (its 128-pair early-out may stop a
    saturated tile one block before K1's 256-row one)."""
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
