"""PatchMatch texture synthesis of the port (segsplat_tpu_torch/ops/
inpaint_patch.py) against the JAX package's:

  * the host tables (``_level_masks``, ``_host_level``) equal, at odd sizes too;
  * ``_patch_mat`` (copies only) equal to the JAX one;
  * ``inpaint_texture`` fed the JAX package's own draws (its key schedule
    replayed, ``_torch_port.jax_draws``): the fill at 1e-5 and every level's
    NNF equal on the images of tests/test_inpaint_patch.py (stripes,
    checkerboard, a constant image, a hole on two borders at 33×47). The
    stripes are cut from 64² to the checkerboard's 48² so that the JAX
    package compiles once for both; at 64² their fields differ at exact cost
    ties (ROADMAP Queue 3);
  * on a noise texture, where many sources nearly tie, the count of differing
    NNF entries and the largest gap of their patch costs, each within the
    float32 rounding of the 147-term sum (printed under ``-s``);
  * the port's own draws (a CPU ``torch.Generator``): the stripes recovered
    exactly and the checkerboard at under a quarter of push–pull's error,
    known pixels bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from segsplat_tpu.ops import inpaint_patch as JP
from segsplat_tpu.ops.inpaint import inpaint_pushpull as jax_inpaint_pushpull
from segsplat_tpu_torch.ops import inpaint_patch as TP
from _torch_port import jax_draws, nnf_near_ties, torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


def _hole(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


def _stripes(h=64, w=64, period=8):
    xx = np.arange(w)[None, :].repeat(h, axis=0)
    g = (0.5 + 0.45 * np.sin(xx * (2 * np.pi / period))).astype(np.float32)
    return np.stack([g, g * 0.8, 1 - g], axis=-1)


def _checker(h=48, w=48):
    yy, xx = np.mgrid[:h, :w]
    chk = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
    return np.stack([chk, 1 - chk, chk * 0.5], axis=-1) * 0.8 + 0.1


def _border_hole():
    h = np.zeros((33, 47), bool)
    h[:6, 40:] = True
    return h


# name: (image, hole, inpaint_texture keywords): tests/test_inpaint_patch.py's
# images; each distinct (level size, hole bucket, iterations) costs the JAX
# package a compile of a few seconds, so all but the odd sizes share the
# checkerboard's (48×48, a 12×12 hole, 4 × 2 iterations)
SHARED = dict(pm_iters=4, em_iters=2)
CASES = {
    "stripes": (lambda: _stripes(48, 48), _hole(48, 48, 18, 30, 18, 30), dict(SHARED, seed=0)),
    "checker": (_checker, _hole(48, 48, 18, 30, 18, 30), dict(SHARED, seed=0)),
    # every cost ties at 0; at the checkerboard's sizes, which JAX has compiled
    "constant": (lambda: np.full((48, 48, 3), 0.3, np.float32), _hole(48, 48, 10, 20, 12, 26),
                 dict(SHARED, seed=1)),
    "border_odd": (lambda: np.random.default_rng(3).random((33, 47, 3)).astype(np.float32),
                   _border_hole(), dict(pm_iters=3, em_iters=1, seed=2)),
}


def _random_mask(seed, h, w):
    rng = np.random.default_rng(seed)
    m = rng.random((h, w)) < 0.05
    m[rng.integers(0, h // 2):, rng.integers(0, w // 2):][:9, :7] = True
    return m


@pytest.mark.parametrize("h,w", ((64, 64), (33, 47), (73, 51), (5, 9)))
def test_host_tables_equal_jax(h, w):
    hole = _random_mask(h * w, h, w)
    levels = JP._level_masks(hole, 4)
    got = TP._level_masks(hole, 4)
    assert len(got) == len(levels)
    for a, b in zip(got, levels):
        np.testing.assert_array_equal(a, b)
        for patch in (3, 7):
            for x, y in zip(TP._host_level(a, patch), JP._host_level(b, patch)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    full = np.ones((6, 5), bool)                # a fully masked level: every source allowed
    np.testing.assert_array_equal(TP._host_level(full, 7)[2], JP._host_level(full, 7)[2])


def test_patch_mat_equals_jax():
    import torch

    img = np.random.default_rng(0).random((13, 9, 3)).astype(np.float32)
    got = TP._patch_mat(torch.from_numpy(img), 7).numpy()
    want = jax.jit(JP._patch_mat, static_argnums=1)(jnp.asarray(img), 7)   # one compile
    np.testing.assert_array_equal(got, np.asarray(want))


def _jax_fill_with_nnfs(img, hole, kw, monkeypatch):
    """The JAX ``inpaint_texture``'s fill, and each level's estimate, hole list
    [Nh, 2] and final NNF [Nh, 2], recorded around its ``_pm_level``."""
    levels = []
    orig = JP._pm_level

    def recording(lvl_img, *args, **kwargs):
        out, nnf = orig(lvl_img, *args, **kwargs)
        nh = int(np.asarray(args[4]).sum())                 # live rows
        levels.append((np.asarray(out), np.asarray(args[1]).T[:nh],
                       np.asarray(nnf).T[:nh].astype(np.int64)))
        return out, nnf

    monkeypatch.setattr(JP, "_pm_level", recording)
    return JP.inpaint_texture(img, hole, **kw), levels


@pytest.mark.parametrize("case", sorted(CASES))
def test_texture_with_jax_draws_matches_jax(case, monkeypatch):
    make, hole, kw = CASES[case]
    img = make()
    want, levels = _jax_fill_with_nnfs(img, hole, kw, monkeypatch)
    got, nnfs = TP.inpaint_texture_at(img, hole, jax_draws(kw["seed"]), device="cpu", **kw)
    assert len(nnfs) == len(levels) >= 1
    for li, (nnf, (lvl_out, hole_yx, ref)) in enumerate(zip(nnfs, levels)):
        n_diff, gap = nnf_near_ties(lvl_out, hole_yx, nnf, ref, 7, img.shape[2])
        print(f"{case} level {li}: {n_diff} of {len(ref)} NNF entries differ, largest cost "
              f"gap {gap:.3g}")
        assert n_diff == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[~hole], img[~hole])


def test_noise_texture_near_ties(monkeypatch):
    """A noise texture, where many sources score alike: the NNF entries that
    differ, each a near-tie of the two sources' costs on the level's estimate
    (tests/test_inpaint_patch.py's sequence case, the checkerboard's sizes)."""
    img = np.random.default_rng(5).random((48, 48, 3)).astype(np.float32)
    hole = _hole(48, 48, 18, 30, 18, 30)
    kw = dict(SHARED, seed=0)
    want, levels = _jax_fill_with_nnfs(img, hole, kw, monkeypatch)
    got, nnfs = TP.inpaint_texture_at(img, hole, jax_draws(0), device="cpu", **kw)
    total = 0
    for li, (nnf, (lvl_out, hole_yx, ref)) in enumerate(zip(nnfs, levels)):
        n_diff, gap = nnf_near_ties(lvl_out, hole_yx, nnf, ref, 7, 3)
        total += n_diff
        print(f"level {li}: {len(ref)} hole pixels, {n_diff} NNF entries differ, "
              f"largest cost gap {gap:.3g}")
    if total == 0:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[~hole], img[~hole])


def test_own_draws_quality():
    stripes = _stripes()
    hole = _hole(64, 64, 24, 40, 24, 40)
    out = TP.inpaint_texture(stripes, hole, seed=0, device="cpu")
    assert out.dtype == np.float32
    assert np.abs(out - stripes)[hole].max() < 1e-4
    np.testing.assert_array_equal(out[~hole], stripes[~hole])

    chk = _checker()
    hole = _hole(48, 48, 18, 30, 18, 30)
    tex = TP.inpaint_texture(chk, hole, pm_iters=4, em_iters=2, seed=0, device="cpu")
    mem = np.asarray(jax_inpaint_pushpull(chk, hole))
    e_tex, e_mem = np.abs(tex - chk)[hole].mean(), np.abs(mem - chk)[hole].mean()
    print(f"checkerboard: texture {e_tex:.4f}, push-pull {e_mem:.4f}")
    assert e_tex < 0.05 and e_tex < 0.25 * e_mem, (e_tex, e_mem)
    # no hole: the image itself
    np.testing.assert_array_equal(TP.inpaint_texture(chk, np.zeros((48, 48), bool),
                                                     device="cpu"), chk)


def test_sequence_reuses_the_previous_fill():
    img = np.random.default_rng(5).random((48, 48, 3)).astype(np.float32)
    hole = _hole(48, 48, 18, 30, 18, 30)
    kw = dict(SHARED, seed=0)
    seq = TP.inpaint_sequence([img, img], [hole, hole], device="cpu", **kw)
    first = TP.inpaint_texture(img, hole, device="cpu", **kw)
    np.testing.assert_array_equal(seq[0], first)
    np.testing.assert_array_equal(
        seq[1], TP.inpaint_texture(img, hole, init_fill=first, device="cpu", **kw))
    d_seq = np.abs(seq[1] - seq[0])[hole].mean()
    indep = [TP.inpaint_texture(img, hole, device="cpu", pm_iters=4, em_iters=2, seed=s)
             for s in (0, 1)]
    assert d_seq < 0.8 * np.abs(indep[1] - indep[0])[hole].mean()
