"""Push–pull hole filling of the port (segsplat_tpu_torch/ops/inpaint.py)
against the JAX package's on the cases of tests/test_inpaint.py and
tests/test_inpaint_quality.py: a constant image, a linear ramp, a hole on the
frame's border, odd sizes (whose pyramids halve by floor, 33 → 16 → 8 …) and a
batch. Fills at 1e-5; known pixels bit-equal to the input."""

import numpy as np
import pytest
import torch

from segsplat_tpu.ops.inpaint import inpaint_frames as jax_inpaint_frames
from segsplat_tpu.ops.inpaint import inpaint_pushpull as jax_inpaint_pushpull
from segsplat_tpu_torch.ops.inpaint import inpaint_frames, inpaint_pushpull
from _torch_port import torch_threads

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


def _hole(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


def _ramp(h=40, w=40):
    return np.broadcast_to(np.linspace(0, 1, w, dtype=np.float32), (h, w))[..., None].copy()


def _border(h=64, w=64):
    img = np.zeros((h, w, 3), np.float32)
    img[:, :w // 2] = [0.1, 0.6, 0.1]
    img[:, w // 2:] = [0.9, 0.1, 0.1]
    return img


CASES = {
    "constant": (lambda: np.full((32, 48, 3), 0.6, np.float32), _hole(32, 48, 10, 20, 15, 30), 64),
    "ramp": (_ramp, _hole(40, 40, 14, 26, 14, 26), 400),
    "border": (_border, _hole(64, 64, 24, 40, 0, 6), 256),
    "odd_noise": (lambda: np.random.default_rng(0).random((33, 47, 3)).astype(np.float32),
                  _hole(33, 47, 5, 12, 20, 33), 64),
    "odd_corner": (lambda: np.random.default_rng(3).random((37, 21, 2)).astype(np.float32),
                   _hole(37, 21, 30, 37, 15, 21), 16),
    "one_column": (lambda: np.random.default_rng(4).random((9, 1, 3)).astype(np.float32),
                   _hole(9, 1, 3, 6, 0, 1), 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pushpull_matches_jax(case):
    make, hole, iters = CASES[case]
    img = make()
    got = inpaint_pushpull(img, hole, smooth_iters=iters, device="cpu")
    assert got.dtype == torch.float32 and got.shape == img.shape
    got = got.numpy()
    want = np.asarray(jax_inpaint_pushpull(img, hole, smooth_iters=iters))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[~hole], img[~hole])
    if case == "constant":
        np.testing.assert_allclose(got, 0.6, atol=1e-5)
    if case == "ramp":
        assert np.abs(got - img)[hole].max() < 0.02
    if case == "border":          # the near edge's green, not the far edge's red
        assert got[24:40, 0:6, 1].mean() > 0.45 and got[24:40, 0:6, 0].mean() < 0.3


def test_frames_batch_matches_jax_and_single():
    rng = np.random.default_rng(1)
    imgs = rng.random((3, 16, 24, 3)).astype(np.float32)
    masks = np.stack([_hole(16, 24, 4, 8, 6, 12), _hole(16, 24, 0, 5, 0, 24),
                      _hole(16, 24, 9, 16, 17, 24)])
    got = inpaint_frames(imgs, masks, smooth_iters=8, device="cpu").numpy()
    want = np.asarray(jax_inpaint_frames(imgs, masks, smooth_iters=8))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for v in range(3):
        np.testing.assert_array_equal(got[v][~masks[v]], imgs[v][~masks[v]])
        single = inpaint_pushpull(torch.from_numpy(imgs[v]), torch.from_numpy(masks[v]),
                                  smooth_iters=8, device="cpu").numpy()
        np.testing.assert_array_equal(got[v], single)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        inpaint_pushpull(np.zeros((4, 4, 3), np.float32), np.ones((4, 4), bool))
