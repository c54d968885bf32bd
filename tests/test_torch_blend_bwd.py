"""Kernel K2's plain version (segsplat_tpu_torch/ops/blend.py
``blend_tiles_bwd_plain_with_work``) held against the JAX Pallas backward
``_blend_bwd_pallas`` in interpret mode, on the same payload, forward outputs
and cotangents, at the training raster's 19 channels. The CUDA kernel itself is
held against the plain version on the card by tests/test_torch_blend_cuda.py
and chip_smoke.py."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu.ops.blend_pallas import GEOM, PAYLOAD_WIDTH
from segsplat_tpu.ops.blend_pallas_vjp import _blend_bwd_pallas, _image_to_tiles
from segsplat_tpu_torch.ops import blend as B
from _torch_port import (BLEND_CASES, DEGENERATE_K, blend_case_args, degenerate_case_args,
                         jax_g_block, owned_rows)

CH = 19


def _case(case: str):
    """Port inputs for the case, the forward's outputs (plain K1) and seeded
    cotangents."""
    return _with_cotangents(blend_case_args(case, "cpu", ch=CH),
                            sorted(BLEND_CASES).index(case))


def _with_cotangents(blend_args, seed: int):
    """The backward's arguments: the blend's, its plain forward's outputs and
    cotangents drawn from ``seed``."""
    offsets, payload, bg, tx_n, ty_n, K = blend_args
    img, alpha = B.blend_tiles_plain(offsets, payload, bg, tx_n, ty_n, K)
    rng = np.random.default_rng(seed)
    g_img = torch.from_numpy(rng.standard_normal(img.shape).astype(np.float32))
    g_alpha = torch.from_numpy(rng.standard_normal(alpha.shape).astype(np.float32))
    return offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K


def _jax_backward(offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K):
    """The TPU backward on the same inputs: its 128-lane payload rows, tile
    layouts, and G chosen as blend_core chooses it."""
    rows = np.zeros((payload.shape[0], PAYLOAD_WIDTH), np.float32)
    rows[:, :GEOM + CH] = payload[:, :GEOM + CH].numpy()
    T = tx_n * ty_n
    tiles = lambda x: _image_to_tiles(jnp.asarray(x.numpy()), tx_n, ty_n)
    with pltpu.force_tpu_interpret_mode():
        d_rows, d_bg = _blend_bwd_pallas(
            jnp.asarray(offsets.numpy()), jnp.asarray(rows), jnp.asarray(bg.numpy()),
            tiles(img), tiles(alpha).reshape(T, 1, 256), tiles(g_img),
            tiles(g_alpha).reshape(T, 1, 256), tx_n, ty_n, K,
            g_block=jax_g_block(K, B.g_block(K)))
    d_rows = np.asarray(d_rows)
    ref = np.zeros(payload.shape, np.float32)
    ref[:, :6] = d_rows[:, :6]
    ref[:, GEOM:GEOM + CH] = d_rows[:, GEOM:GEOM + CH]
    return ref, np.asarray(d_bg)


def _assert_close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=2e-4 * (np.abs(ref).max() + 1e-6),
                               err_msg=name)


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_plain_backward_matches_pallas_kernel(case):
    args = _case(case)
    offsets, payload, K = args[0], args[1], args[-1]
    d_pay, d_bg, rows_read, pixels_hit = B.blend_tiles_bwd_plain_with_work(*args)
    ref_pay, ref_bg = _jax_backward(*args)
    _assert_close(d_pay.numpy(), ref_pay, "d_payload")
    _assert_close(d_bg.numpy(), ref_bg, "d_bg")

    off = offsets.numpy()
    counts = np.minimum(np.diff(off), K)
    assert rows_read == counts.sum(), "the backward reads every row up to count"
    assert 0 < pixels_hit < rows_read * 256
    owned = owned_rows(off, K, payload.shape[0])
    assert not d_pay.numpy()[~owned].any(), "rows no tile owns must be exact zeros"
    assert np.abs(d_pay.numpy()[owned]).max() > 0
    if "pair_cap" in case:
        assert (~owned).sum() > K, "pair_cap must leave rows beyond the K-row tail"


def test_plain_backward_matches_pallas_kernel_on_degenerate_tiles():
    """Empty tiles and tiles past the K cap: the rows past the cap stay exactly
    0, as in the TPU kernel, which writes only a tile's first K rows."""
    args = _with_cotangents(degenerate_case_args("cpu", ch=CH), 11)
    offsets, payload = args[0].numpy(), args[1]
    d_pay, d_bg, rows_read, _ = B.blend_tiles_bwd_plain_with_work(*args)
    ref_pay, ref_bg = _jax_backward(*args)
    _assert_close(d_pay.numpy(), ref_pay, "d_payload")
    _assert_close(d_bg.numpy(), ref_bg, "d_bg")
    assert rows_read == np.minimum(np.diff(offsets), DEGENERATE_K).sum()
    owned = owned_rows(offsets, DEGENERATE_K, payload.shape[0])
    past_cap = np.arange(offsets[1] + DEGENERATE_K, offsets[2])
    assert past_cap.size and not owned[past_cap].any()
    assert not d_pay.numpy()[~owned].any() and not ref_pay[~owned].any()
    assert np.abs(d_pay.numpy()[owned]).max() > 0


def test_rows_of_a_short_tile_do_not_clobber_the_next():
    """A tile with count < K must leave the next tile's rows to that tile (the
    TPU kernel writes a whole K-row window, which is right only in order)."""
    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = _case("k128_one_block")
    off = offsets.numpy()
    counts = np.diff(off)
    short = [t for t in range(len(counts) - 1) if 0 < counts[t] < K and counts[t + 1] > 0]
    assert short, "the scene must have a short tile followed by a non-empty one"
    d_pay, _ = B.blend_tiles_bwd_plain(offsets, payload, bg, img, alpha, g_img, g_alpha,
                                       tx_n, ty_n, K)
    nxt = [off[t + 1] for t in short]
    assert np.abs(d_pay.numpy()[nxt]).max() > 0


def test_backward_keeps_gradient_behind_the_forward_early_out():
    """The forward stops a tile once all its pixels saturate; the backward still
    gives the rows behind that block the gradient of the exact compositing."""
    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = _case(
        "k384_opaque_early_out")
    G = B.g_block(K)
    # the transmittance after the first block: the forward with K = G
    _, alpha_g = B.blend_tiles_plain(offsets, payload, bg, tx_n, ty_n, G)
    t_after = (1.0 - B._to_tiles(alpha_g, tx_n, ty_n)).amax(dim=1)
    off = offsets.numpy()
    counts = np.minimum(np.diff(off), K)
    stopped = [t for t in range(len(counts)) if counts[t] > G and t_after[t] < B.SAT_EPS]
    assert stopped, "some tile must stop after its first block"
    d_pay, _ = B.blend_tiles_bwd_plain(offsets, payload, bg, img, alpha, g_img, g_alpha,
                                       tx_n, ty_n, K)
    behind = np.concatenate([np.arange(off[t] + G, off[t] + counts[t]) for t in stopped])
    assert np.abs(d_pay.numpy()[behind]).max() > 0


def test_wrapper_runs_plain_backward_on_cpu_tensors():
    args = _case("k128_one_block")
    before = B.blend_tiles_bwd.launches
    got = B.blend_tiles_bwd(*args)
    ref = B.blend_tiles_bwd_plain(*args)
    assert B.blend_tiles_bwd.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = args
    with pytest.raises(ValueError, match="g_img"):
        B.blend_tiles_bwd(offsets, payload, bg, img, alpha, g_img[:-16], g_alpha,
                          tx_n, ty_n, K)
    with pytest.raises(ValueError, match="alpha"):
        B.blend_tiles_bwd(offsets, payload, bg, img, alpha.double(), g_img, g_alpha,
                          tx_n, ty_n, K)


def test_autograd_blend_matches_explicit_backward():
    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = _case("k256_one_block")
    pay = payload.clone().requires_grad_(True)
    bgv = bg.clone().requires_grad_(True)
    out_img, out_alpha = B.blend(offsets, pay, bgv, tx_n, ty_n, K)
    assert torch.equal(out_img, img) and torch.equal(out_alpha, alpha)
    ((out_img * g_img).sum() + (out_alpha * g_alpha).sum()).backward()
    ref_pay, ref_bg = B.blend_tiles_bwd_plain(offsets, payload, bg, img, alpha, g_img,
                                              g_alpha, tx_n, ty_n, K)
    assert torch.equal(pay.grad, ref_pay)
    torch.testing.assert_close(bgv.grad, ref_bg)


def test_compiled_blend_gradient_equals_eager_bits():
    """``blend`` under torch.compile (aot_eager): K1's and K2's ops stay whole in
    the forward and backward graphs, so forward and gradients are the eager
    blend's bits; the op refuses a second derivative."""
    offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, K = _case("k384_three_blocks_carry")

    def loss(pay, bgv):
        out_img, out_alpha = B.blend(offsets, pay, bgv, tx_n, ty_n, K)
        return (out_img * g_img).sum() + (out_alpha * g_alpha).sum()

    grads = []
    for fn in (loss, torch.compile(loss, backend="aot_eager", fullgraph=True)):
        pay, bgv = payload.clone().requires_grad_(True), bg.clone().requires_grad_(True)
        value = fn(pay, bgv)
        value.backward()
        grads.append((value.detach(), pay.grad, bgv.grad))
    for e, c in zip(*grads):
        assert torch.equal(c, e)
    assert grads[0][1].abs().max() > 0
    pay, w = payload.clone().requires_grad_(True), g_img.clone().requires_grad_(True)
    out_img, _ = B.blend(offsets, pay, bg, tx_n, ty_n, K)
    (d_pay,) = torch.autograd.grad((out_img * w).sum(), pay, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        d_pay.sum().backward()


def test_k2_diagnostic_variants_follow_the_kernel_source():
    """scripts/k2_variants.py finds its anchors in csrc/blend_bwd.cu: each
    diagnostic variant is the kernel with its own edit, and the clock variant
    marks every segment once."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import k2_variants as KV

    src = KV.SOURCE.read_text()
    out = KV.variants(src)
    assert sorted(out) == ["clocks", "empty", "noA", "noAB", "noB"]
    assert len({src, *out.values()}) == 6
    assert all(out["clocks"].count(f"K2_MARK({i})") == 1 for i in range(len(KV.SEGMENTS)))
    assert "expf(-sigma)" not in out["noA"] and "expf(-sigma)" in out["noB"]
