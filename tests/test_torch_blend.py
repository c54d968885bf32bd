"""Kernel K1's plain version (segsplat_tpu_torch/ops/blend.py) held against the
JAX Pallas kernel blend_tiles_pallas_dma in interpret mode, on the same payload;
and the wrapper's dispatch and checks. The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_blend_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu.ops import rasterize as Rz
from segsplat_tpu.ops.blend_pallas import GEOM, PAYLOAD_WIDTH, blend_tiles_pallas_dma
from segsplat_tpu_torch.ops import blend as B
from _torch_port import (BLEND_CASES, F, H, SCENES, W, assert_case_exercised, scene,
                         viewmat)

CH = 32
# the cases without pair_cap: the JAX payload below is built untruncated
UNCAPPED = sorted(c for c, (_, _, cap) in BLEND_CASES.items() if cap is None)


def _jax_payload(kind: str, K: int):
    """offsets and the JAX kernel's 128-lane payload, built as
    ops/rasterize._blend_tiles_pallas builds them."""
    seed, n, log_scale, opac_range = SCENES[kind]
    sc = scene(seed, n, log_scale, opac_range, ch=CH)
    proj = Rz.project_gaussians(jnp.asarray(sc["xyz"]), jnp.asarray(sc["scales"]),
                                jnp.asarray(sc["quats"]), jnp.asarray(viewmat("identity")),
                                F, F, W / 2, H / 2, W, H)
    order, ranks, offsets, (tx_n, ty_n) = Rz._bin_gaussian_ranks(proj, W, H, 4)
    payload = np.zeros((n, PAYLOAD_WIDTH), np.float32)
    payload[:, 0:2] = np.asarray(proj.means2d)
    payload[:, 2:5] = np.asarray(proj.conics)
    payload[:, 5] = sc["opac"]
    payload[:, GEOM:GEOM + CH] = sc["colors"]
    rows = payload[np.asarray(order)][np.asarray(ranks)]
    rows = np.concatenate([rows, np.zeros((K, PAYLOAD_WIDTH), np.float32)])
    return np.array(offsets), rows, sc["bg"], tx_n, ty_n


@pytest.mark.parametrize("case", UNCAPPED)
def test_plain_blend_matches_pallas_kernel(case):
    kind, K, _ = BLEND_CASES[case]
    offsets, rows, bg, tx_n, ty_n = _jax_payload(kind, K)
    with pltpu.force_tpu_interpret_mode():
        ref_img, ref_alpha = blend_tiles_pallas_dma(
            jnp.asarray(offsets), jnp.asarray(rows), jnp.asarray(bg), tx_n, ty_n, K)
    port_rows = torch.from_numpy(np.ascontiguousarray(rows[:, :B.payload_width(CH)]))
    img, alpha, rows_read, pixels_hit, _ = B.blend_tiles_plain_with_work(
        torch.from_numpy(offsets), port_rows, torch.from_numpy(bg), tx_n, ty_n, K)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha), rtol=1e-4, atol=1e-4)

    assert_case_exercised(case, offsets, K, rows_read)
    assert 0 < pixels_hit < rows_read * 256


def test_wrapper_runs_plain_version_on_cpu_tensors():
    offsets, rows, bg, tx_n, ty_n = _jax_payload("light", 128)
    args = (torch.from_numpy(offsets),
            torch.from_numpy(np.ascontiguousarray(rows[:, :B.payload_width(CH)])),
            torch.from_numpy(bg))
    before = B.blend_tiles.launches
    got = B.blend_tiles(*args, tx_n, ty_n, 128)
    ref = B.blend_tiles_plain(*args, tx_n, ty_n, 128)
    assert B.blend_tiles.launches == before        # no kernel launch on the CPU
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert got[0].shape == (ty_n * 16, tx_n * 16, CH)

    off, pay, bgt = args
    bad = {
        "k_max": ((off, pay, bgt, tx_n, ty_n, 192), "multiple of 128"),
        "offsets dtype": ((off.long(), pay, bgt, tx_n, ty_n, 128), "int32"),
        "offsets length": ((off[:-1], pay, bgt, tx_n, ty_n, 128), "int32"),
        "payload width": ((off, pay[:, :-4], bgt, tx_n, ty_n, 128), "sorted_payload"),
        "payload layout": ((off, pay.t().contiguous().t(), bgt, tx_n, ty_n, 128),
                           "contiguous"),
        "bg dtype": ((off, pay, bgt.double(), tx_n, ty_n, 128), "bg"),
    }
    for name, (call, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            B.blend_tiles(*call)
