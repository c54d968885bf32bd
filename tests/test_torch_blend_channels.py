"""The blend kernels at every channel count the TPU kernels take: K1 and K2 for
1 ≤ CH ≤ 120 (8 + CH colours in one 128-lane row), K3 for 1 ≤ CH ≤ 56. Each
kernel is built for a ladder of widths (csrc/blend_widths.cuh, read by
segsplat_tpu_torch/ops/blend.py as KERNEL_WIDTHS and PACKED_WIDTHS), and the
wrappers pad CH up to the next width with zero colours and cut the result
back. Here, on the CPU: the ladder covers the range; the padding, run through
the plain versions, gives the direct plain version's bits forward and its
gradient to rtol 1e-6 (the padded sums over channels add zero terms, which
may round differently); and the plain K1, K2 and K3 match the Pallas
kernels in interpret mode at 8 and 23 channels, the pseudo-label loop's GT
sweep widths (1e-4; gradients rtol 5e-3, atol 2e-4·max|ref|). The kernels
themselves run at every width on the card in tests/test_torch_blend_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu.ops import rasterize as Rz
from segsplat_tpu.ops.blend_pallas import GEOM, PAYLOAD_WIDTH, blend_tiles_pallas_dma
from segsplat_tpu.ops.blend_pallas2 import HALF, blend_tiles_pallas_packed
from segsplat_tpu.ops.blend_pallas_vjp import _blend_bwd_pallas, _image_to_tiles
from segsplat_tpu_torch.ops import blend as B
from _torch_port import (F, H, PACKED_G, SCENES, W, blend_case_args, jax_g_block, scene,
                         torch_threads, viewmat)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


LOOP_WIDTHS = (8, 23)          # 3 + n_objects for 5 and 20 objects


def test_width_ladders_cover_what_the_tpu_kernels_take():
    assert B.MAX_CH == PAYLOAD_WIDTH - GEOM == B.KERNEL_WIDTHS[-1] == 120
    assert B.PACKED_MAX_CH == HALF - GEOM == B.PACKED_WIDTHS[-1] == 56
    for widths, top in ((B.KERNEL_WIDTHS, 120), (B.PACKED_WIDTHS, 56)):
        assert list(widths) == sorted(set(widths))
        for ch in range(1, top + 1):
            w = B.kernel_width(ch, widths)
            assert w in widths and w >= ch and not [x for x in widths if ch <= x < w]
        for ch in (0, top + 1):
            with pytest.raises(ValueError, match="channels"):
                B.kernel_width(ch, widths)
    for ch in B.KERNEL_CHANNELS:        # the main paths' widths launch unpadded
        assert B.kernel_width(ch) == ch and B.kernel_width(ch, B.PACKED_WIDTHS) == ch


def _with_cotangents(args, seed):
    offsets, payload, bg, tx_n, ty_n, K = args
    img, alpha = B.blend_tiles_plain(offsets, payload, bg, tx_n, ty_n, K)
    rng = np.random.default_rng(seed)
    g_img = torch.from_numpy(rng.standard_normal(img.shape).astype(np.float32))
    g_alpha = torch.from_numpy(rng.standard_normal(alpha.shape).astype(np.float32))
    return offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K


@pytest.mark.parametrize("ch", (1, 3, 5, 7, 17, 23, 33, 60, 100))
@pytest.mark.parametrize("case", ("k384_three_blocks_carry", "k200_partial_block"))
def test_padded_plain_versions_give_the_same_bits(case, ch):
    """The wrappers' padding (forward_at_width, backward_at_width) around the
    plain K1 and K2 at the next width equals the plain versions at CH: the
    forward bit for bit, the gradient to rtol 1e-6 (K2's plain version sums
    over the channels it is given, so the padded call adds zero terms)."""
    args = blend_case_args(case, "cpu", ch=ch)
    width = B.kernel_width(ch)
    assert width > ch
    img, alpha = B.blend_tiles_plain(*args)
    p_img, p_alpha = B.forward_at_width(B.blend_tiles_plain, *args)
    assert p_img.shape == img.shape and torch.equal(p_img, img)
    assert torch.equal(p_alpha, alpha)

    bwd_args = _with_cotangents(args, ch)
    d_payload = B.blend_tiles_bwd_plain(*bwd_args)[0]
    p_d = B.backward_at_width(lambda *a: B.blend_tiles_bwd_plain(*a)[0], *bwd_args)
    assert p_d.shape == d_payload.shape
    torch.testing.assert_close(p_d, d_payload, rtol=1e-6,
                               atol=1e-6 * float(d_payload.abs().max()))
    assert d_payload.abs().max() > 0


@pytest.mark.parametrize("ch", (3, 7, 23, 50))
def test_padded_packed_plain_gives_the_same_bits(ch):
    args = blend_case_args("k384_three_blocks_carry", "cpu", ch=ch, packed=True)
    assert B.kernel_width(ch, B.PACKED_WIDTHS) > ch
    direct = B.blend_tiles_packed_plain(*args)
    padded = B.forward_at_width(B.blend_tiles_packed_plain, *args, PACKED_G, packed=True)
    for d, p in zip(direct, padded):
        assert p.shape == d.shape and torch.equal(p, d)


def test_wrappers_refuse_widths_past_the_range_on_the_cpu():
    offsets, payload, bg, tx_n, ty_n, K = blend_case_args("k128_one_block", "cpu", ch=8)
    wide = torch.zeros(B.MAX_CH + 1)
    wide_rows = torch.zeros((payload.shape[0], B.payload_width(B.MAX_CH + 1)))
    with pytest.raises(ValueError, match="1 to 120 channels"):
        B.blend_tiles(offsets, wide_rows, wide, tx_n, ty_n, K)
    packed = blend_case_args("k128_one_block", "cpu", ch=8, packed=True)[1]
    with pytest.raises(ValueError, match="at most 56"):
        B.blend_tiles_packed(offsets, packed, torch.zeros(B.PACKED_MAX_CH + 1), tx_n, ty_n, K)


def _jax_rows(kind: str, K: int, ch: int, width: int):
    """offsets and depth-sorted JAX payload rows of ``width`` floats, as
    segsplat_tpu/ops/rasterize.py builds them, with K zero rows appended."""
    seed, n, log_scale, opac_range = SCENES[kind]
    sc = scene(seed, n, log_scale, opac_range, ch=ch)
    proj = Rz.project_gaussians(jnp.asarray(sc["xyz"]), jnp.asarray(sc["scales"]),
                                jnp.asarray(sc["quats"]), jnp.asarray(viewmat("identity")),
                                F, F, W / 2, H / 2, W, H)
    order, ranks, offsets, (tx_n, ty_n) = Rz._bin_gaussian_ranks(proj, W, H, 4)
    payload = np.zeros((n, width), np.float32)
    payload[:, 0:2] = np.asarray(proj.means2d)
    payload[:, 2:5] = np.asarray(proj.conics)
    payload[:, 5] = sc["opac"]
    payload[:, GEOM:GEOM + ch] = sc["colors"]
    rows = payload[np.asarray(order)][np.asarray(ranks)]
    return np.array(offsets), rows, sc["bg"], tx_n, ty_n


def _close(got, ref, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("ch", LOOP_WIDTHS)
def test_plain_k1_and_k2_match_the_pallas_kernels(ch):
    K = 384
    offsets, rows, bg, tx_n, ty_n = _jax_rows("deep", K, ch, PAYLOAD_WIDTH)
    rows = np.concatenate([rows, np.zeros((K, PAYLOAD_WIDTH), np.float32)])
    g = jax_g_block(K, B.g_block(K))
    with pltpu.force_tpu_interpret_mode():
        ref_img, ref_alpha = blend_tiles_pallas_dma(
            jnp.asarray(offsets), jnp.asarray(rows), jnp.asarray(bg), tx_n, ty_n, K,
            g_block=g)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    port_rows = t(rows[:, :B.payload_width(ch)])
    args = (t(offsets), port_rows, t(bg), tx_n, ty_n, K)
    img, alpha = B.blend_tiles(*args)
    _close(img, ref_img)
    _close(alpha, ref_alpha)

    bwd = _with_cotangents(args, 100 + ch)
    d_payload, d_bg = B.blend_tiles_bwd(*bwd)
    tiles = lambda x: _image_to_tiles(jnp.asarray(x.numpy()), tx_n, ty_n)
    T = tx_n * ty_n
    with pltpu.force_tpu_interpret_mode():
        ref_rows, ref_bg = _blend_bwd_pallas(
            jnp.asarray(offsets), jnp.asarray(rows), jnp.asarray(bg), tiles(bwd[3]),
            tiles(bwd[4]).reshape(T, 1, 256), tiles(bwd[5]),
            tiles(bwd[6]).reshape(T, 1, 256), tx_n, ty_n, K, g_block=g)
    ref_rows = np.asarray(ref_rows)
    ref = np.zeros(port_rows.shape, np.float32)
    ref[:, :6] = ref_rows[:, :6]
    ref[:, GEOM:GEOM + ch] = ref_rows[:, GEOM:GEOM + ch]
    for got, want in ((d_payload.numpy(), ref), (d_bg.numpy(), np.asarray(ref_bg))):
        _close(got, want, rtol=5e-3, atol=2e-4 * (np.abs(want).max() + 1e-6))
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("ch", LOOP_WIDTHS)
def test_plain_k3_matches_the_packed_pallas_kernel(ch):
    K = 256
    offsets, rows, bg, tx_n, ty_n = _jax_rows("opaque", K, ch, 64)
    pad = K + 4 + (rows.shape[0] + K + 4) % 2
    packed = np.concatenate([rows, np.zeros((pad, 64), np.float32)]).reshape(-1, 128)
    with pltpu.force_tpu_interpret_mode():
        ref_img, ref_alpha = blend_tiles_pallas_packed(
            jnp.asarray(offsets), jnp.asarray(packed), jnp.asarray(bg), tx_n, ty_n, K,
            g_block=jax_g_block(K, PACKED_G))
    img, alpha = B.blend_tiles_packed(torch.from_numpy(offsets), torch.from_numpy(packed),
                                      torch.from_numpy(bg), tx_n, ty_n, K)
    _close(img, ref_img)
    _close(alpha, ref_alpha)
