"""Kernel K3's plain version (segsplat_tpu_torch/ops/blend.py
``blend_tiles_packed_plain``) held against the JAX Pallas kernel
blend_tiles_pallas_packed in interpret mode, on the packed payload built as
segsplat_tpu/ops/rasterize.py:431-439 builds it; against K1's plain version;
the wrapper's checks; and the packed branch of the port's ``rasterize``. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_blend_cuda.py and chip_smoke.py.

Tolerances: 1e-4 (abs + rel) against the JAX kernel, as for K1. Against K1,
1e-4 + 2·SAT_EPS·max(|colour|, |bg|): K3 stops a saturated tile at a 128-pair
boundary where K1 (G = 256 when K % 256 == 0) may read on, and what it leaves
out is below SAT_EPS of transmittance times a colour."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu.ops import rasterize as Rz
from segsplat_tpu.ops.blend_pallas import GEOM
from segsplat_tpu.ops.blend_pallas2 import blend_tiles_pallas_packed
from segsplat_tpu_torch.ops import blend as B
from segsplat_tpu_torch.ops import rasterize as Pr
from _torch_port import (F, H, PACKED_CASES, PACKED_G, SCENES, W, assert_case_exercised,
                         blend_case_args, scene, viewmat)

UNCAPPED = sorted(c for c, (_, _, cap) in PACKED_CASES.items() if cap is None)


def _jax_packed(kind: str, K: int, ch: int):
    """offsets and the JAX kernel's packed payload [R, 128], built as
    segsplat_tpu/ops/rasterize.py:431-439 builds them."""
    seed, n, log_scale, opac_range = SCENES[kind]
    sc = scene(seed, n, log_scale, opac_range, ch=ch)
    proj = Rz.project_gaussians(jnp.asarray(sc["xyz"]), jnp.asarray(sc["scales"]),
                                jnp.asarray(sc["quats"]), jnp.asarray(viewmat("identity")),
                                F, F, W / 2, H / 2, W, H)
    order, ranks, offsets, (tx_n, ty_n) = Rz._bin_gaussian_ranks(proj, W, H, 4)
    payload = np.zeros((n, 64), np.float32)
    payload[:, 0:2] = np.asarray(proj.means2d)
    payload[:, 2:5] = np.asarray(proj.conics)
    payload[:, 5] = sc["opac"]
    payload[:, GEOM:GEOM + ch] = sc["colors"]
    rows = payload[np.asarray(order)][np.asarray(ranks)]
    pad = K + 4 + (rows.shape[0] + K + 4) % 2
    packed = np.concatenate([rows, np.zeros((pad, 64), np.float32)]).reshape(-1, 128)
    return np.array(offsets), packed, sc["bg"], tx_n, ty_n


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("ch", B.KERNEL_CHANNELS)
@pytest.mark.parametrize("case", UNCAPPED)
def test_packed_plain_matches_pallas_kernel(case, ch):
    kind, K, _ = PACKED_CASES[case]
    offsets, packed, bg, tx_n, ty_n = _jax_packed(kind, K, ch)
    with pltpu.force_tpu_interpret_mode():
        ref_img, ref_alpha = blend_tiles_pallas_packed(
            jnp.asarray(offsets), jnp.asarray(packed), jnp.asarray(bg), tx_n, ty_n, K)
    img, alpha, rows_read, pixels_hit, _ = B.blend_tiles_packed_plain_with_work(
        *_torch(offsets, packed, bg), tx_n, ty_n, K)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha), rtol=1e-4, atol=1e-4)

    assert_case_exercised(case, offsets, K, rows_read, g=PACKED_G)
    assert 0 < pixels_hit < rows_read * 256
    # runs that start at an odd and at an even pair: both halves of a packed row
    starts = offsets[:-1][np.diff(offsets) > 0]
    assert (starts % 2 == 1).any() and (starts % 2 == 0).any()

    # the port's own packing (build_blend_inputs(packed=True)) gives this layout
    p_off, p_packed = blend_case_args(case, "cpu", ch=ch, packed=True)[:2]
    np.testing.assert_array_equal(p_off.numpy(), offsets)
    np.testing.assert_allclose(p_packed.numpy(), packed, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_plain_matches_k1_plain(case):
    dense = blend_case_args(case, "cpu", ch=32)
    packed = blend_case_args(case, "cpu", ch=32, packed=True)
    k1_img, k1_alpha, k1_rows, _, k1_stopped = B.blend_tiles_plain_with_work(*dense)
    k3_img, k3_alpha, k3_rows, _, k3_stopped = B.blend_tiles_packed_plain_with_work(*packed)
    bg, colours = dense[2], dense[1][:, B.GEOM:B.GEOM + 32]
    atol = 1e-4 + 2 * B.SAT_EPS * max(float(colours.abs().max()), float(bg.abs().max()))
    torch.testing.assert_close(k3_img, k1_img, rtol=1e-4, atol=atol)
    torch.testing.assert_close(k3_alpha, k1_alpha, rtol=1e-4, atol=atol)
    K = dense[-1]
    if B.g_block(K) == PACKED_G:          # the same blocks: the same tiles stop
        assert (k3_rows, k3_stopped) == (k1_rows, k1_stopped)
    else:                                 # K3's finer blocks stop no later
        assert k3_rows <= k1_rows and k3_stopped >= k1_stopped
    if case == "k256_opaque_early_out":
        assert k3_stopped > k1_stopped and k3_rows < k1_rows


def test_packed_wrapper_runs_plain_version_and_checks_inputs():
    off, packed, bg, tx_n, ty_n, K = blend_case_args("k128_one_block", "cpu", packed=True)
    before = B.blend_tiles_packed.launches
    got = B.blend_tiles_packed(off, packed, bg, tx_n, ty_n, K)
    ref = B.blend_tiles_packed_plain(off, packed, bg, tx_n, ty_n, K)
    assert B.blend_tiles_packed.launches == before     # no kernel launch on the CPU
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert got[0].shape == (ty_n * 16, tx_n * 16, 32)

    storage = torch.zeros(packed.numel() + 1)
    misaligned = storage[1:].view(packed.shape)         # 4 bytes off a float4
    misaligned.copy_(packed)
    wide_bg = torch.zeros(B.PACKED_MAX_CH + 1)
    bad = {
        "CH > 56": ((off, packed, wide_bg, tx_n, ty_n, K), "at most 56"),
        "misaligned": ((off, misaligned, bg, tx_n, ty_n, K), "16-byte aligned"),
        "pair rows": ((off, packed.view(-1, 64), bg, tx_n, ty_n, K), "packed_payload"),
        "too few rows": ((off, packed[:K // 2 + 1], bg, tx_n, ty_n, K), "packed_payload"),
        "layout": ((off, packed.t().contiguous().t(), bg, tx_n, ty_n, K), "contiguous"),
        "odd g_block": ((off, packed, bg, tx_n, ty_n, K, 127), "g_block"),
        "g_block not dividing K": ((off, packed, bg, tx_n, ty_n, K, 96), "g_block"),
        "offsets dtype": ((off.long(), packed, bg, tx_n, ty_n, K), "int32"),
    }
    for name, (call, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            B.blend_tiles_packed(*call)
    with pytest.raises(ValueError, match="at most 56"):
        B.pack_payload(torch.zeros((10, 68)), K)


def _raster_inputs(ch: int, requires_grad: bool = False):
    seed, n, log_scale, opac_range = SCENES["light"]
    sc = scene(seed, n, log_scale, opac_range, ch=ch)
    t = {k: torch.from_numpy(v).requires_grad_(requires_grad) for k, v in sc.items()}
    return ((t["xyz"], t["scales"], t["quats"], t["opac"], t["colors"],
             torch.from_numpy(viewmat("rotated")), F, F, W / 2, H / 2, W, H),
            dict(bg=t["bg"], max_tiles_per_axis=4, max_per_tile=256))


def test_rasterize_packed_branch(monkeypatch):
    calls = []
    packed_blend = Pr.blend_tiles_packed
    monkeypatch.setattr(Pr, "blend_tiles_packed",
                        lambda *a: calls.append(a) or packed_blend(*a))
    args, kw = _raster_inputs(32)
    ref = Pr.rasterize(*args, **kw, pair_cap=1000)
    monkeypatch.setattr(Pr, "USE_PACKED", True)
    got = Pr.rasterize(*args, **kw, pair_cap=1000)
    assert len(calls) == 1 and calls[0][1].shape[1] == 128
    atol = 1e-4 + 2 * B.SAT_EPS * float(args[4].abs().max())
    for k in ("image", "alpha"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=atol)
    for k in ("radii", "visible", "depths", "num_pairs", "tile_overflow"):
        assert torch.equal(got[k], ref[k]), k
    assert int(got["num_pairs"]) > 1000            # the cap truncates on both branches

    # no backward on the packed branch: it refuses inputs that need a gradient
    g_args, g_kw = _raster_inputs(32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        Pr.rasterize(*g_args, **g_kw)
    with torch.no_grad():
        torch.testing.assert_close(Pr.rasterize(*g_args, **g_kw)["image"],
                                   Pr.rasterize(*args, **kw)["image"], rtol=0, atol=0)
    assert len(calls) == 3

    # more channels than a packed pair holds take the default, differentiable branch
    w_args, w_kw = _raster_inputs(B.PACKED_MAX_CH + 1, requires_grad=True)
    Pr.rasterize(*w_args, **w_kw)["image"].sum().backward()
    assert len(calls) == 3 and w_args[4].grad.abs().max() > 0
