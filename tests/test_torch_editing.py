"""Object selection, the codebook loaders and the kNN-KL 3-D regulariser of the
port against the JAX package: train/editing.py (``classify_gaussians``,
``mask3d_from_classes``, ``select_obj_ioa``), io/artifacts.py
(``load_codebook``, ``find_codebook``) and train/losses.py
(``loss_cls_3d``, held at rtol 1e-5 with the JAX call's own draws fed to
``loss_cls_3d_at``)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.io import artifacts as JA
from segsplat_tpu.scene import table_from_arrays as jax_table_from_arrays
from segsplat_tpu.train import editing as JE
from segsplat_tpu.train.losses import loss_cls_3d as jax_loss_cls_3d
from segsplat_tpu_torch.convert import table_from_jax_arrays
from segsplat_tpu_torch.io import artifacts as TA
from segsplat_tpu_torch.train import editing as TE
from segsplat_tpu_torch.train.losses import loss_cls_3d, loss_cls_3d_at


def _tables(n=300, capacity=512, seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
                  features_rest=rng.normal(size=(n, 15, 3)),
                  scaling=rng.normal(-3, 0.5, (n, 3)), rotation=rng.normal(size=(n, 4)),
                  opacity=rng.normal(size=(n, 1)), objects_dc=rng.normal(size=(n, 1, 16)))
    jt = jax_table_from_arrays({k: v.astype(np.float32) for k, v in arrays.items()},
                               capacity=capacity)
    fields = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)}
    code_book = rng.normal(size=(256, 16)).astype(np.float32)
    return jt, table_from_jax_arrays(fields, device="cpu"), code_book


def test_classify_and_mask3d_match_jax():
    jt, pt, code_book = _tables()
    cls = TE.classify_gaussians(pt, code_book)
    np.testing.assert_array_equal(cls, JE.classify_gaussians(jt, code_book))
    ids = [int(c) for c in np.unique(cls[:300])[:5]]
    got = TE.mask3d_from_classes(pt, code_book, ids)
    np.testing.assert_array_equal(got, JE.mask3d_from_classes(jt, code_book, ids))
    assert got.any() and not got[300:].any()      # inactive rows never selected


def test_classify_takes_the_first_of_tied_maxima():
    jt, pt, _ = _tables(n=20, capacity=32)
    code_book = np.zeros((256, 16), np.float32)          # every logit ties
    np.testing.assert_array_equal(TE.classify_gaussians(pt, code_book), 0)
    np.testing.assert_array_equal(JE.classify_gaussians(jt, code_book), 0)


@pytest.mark.parametrize("threshold", (0.5, 0.7, 0.95))
def test_select_obj_ioa_matches_jax(threshold):
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 12, (40, 50))
    pred[5:20, 5:25] = 4
    sam = np.zeros((40, 50), bool)
    sam[4:22, 3:27] = True
    sam |= rng.random((40, 50)) < 0.3
    got = TE.select_obj_ioa(pred, sam, threshold)
    assert got == JE.select_obj_ioa(pred, sam, threshold)
    assert 4 in got or threshold > 0.9


def test_load_and_find_codebook_in_every_layout(tmp_path):
    code_book = np.random.default_rng(5).normal(size=(256, 16)).astype(np.float32)
    it_dir = tmp_path / "point_cloud" / "iteration_7"
    it_dir.mkdir(parents=True)
    npz, pth = str(it_dir / "classifier.npz"), str(it_dir / "classifier.pth")
    # the reference's classifier.pth in its layouts; nothing but the .pth yet
    for saved in (torch.from_numpy(code_book),
                  torch.from_numpy(code_book)[:, :, None, None],
                  {"weight": torch.from_numpy(code_book)[:, :, None, None]}):
        torch.save(saved, pth)
        assert TA.find_codebook(str(tmp_path), 7) == JA.find_codebook(str(tmp_path), 7) == pth
        got = TA.load_codebook(pth)
        np.testing.assert_array_equal(got, JA.load_codebook(pth))
        np.testing.assert_array_equal(got, code_book)
        assert got.dtype == np.float32
    np.savez(npz, code_book=code_book)          # the npz wins where both exist
    assert TA.find_codebook(str(tmp_path), 7) == JA.find_codebook(str(tmp_path), 7) == npz
    np.testing.assert_array_equal(TA.load_codebook(npz), code_book)
    os.remove(pth)
    assert TA.find_codebook(str(tmp_path), 7) == npz
    os.remove(npz)                              # neither: the npz path, as JAX
    assert TA.find_codebook(str(tmp_path), 7) == JA.find_codebook(str(tmp_path), 7) == npz
    torch.save(torch.zeros(3, 4, 5), pth)
    with pytest.raises(ValueError, match="codebook"):
        TA.load_codebook(pth)


def _jax_draws(key, n, max_points, sample_size):
    """The indices jax.random.choice draws inside the JAX loss_cls_3d."""
    r1, r2 = jax.random.split(key)
    keep = None
    if n > max_points:
        keep = np.array(jax.random.choice(r1, n, (max_points,), replace=False))
        n = max_points
    idx = np.array(jax.random.choice(r2, n, (sample_size,), replace=False))
    return keep, idx


@pytest.mark.parametrize("n,max_points,sample_size,k",
                         ((400, 300000, 100, 5), (900, 600, 200, 7)))
def test_loss_cls_3d_matches_jax_at_the_same_draws(n, max_points, sample_size, k):
    rng = np.random.default_rng(n)
    feats = rng.permutation(n * 3).reshape(n, 3).astype(np.float32) / 97.0  # distinct points
    logits = rng.normal(size=(n, 12))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    want = float(jax_loss_cls_3d(jnp.asarray(feats), jnp.asarray(probs), key, k=k,
                                 max_points=max_points, sample_size=sample_size))
    keep, idx = _jax_draws(key, n, max_points, sample_size)
    got = loss_cls_3d_at(torch.from_numpy(feats), torch.from_numpy(probs),
                         None if keep is None else torch.from_numpy(keep),
                         torch.from_numpy(idx), k=k)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert want > 0

    # its own draws from a torch.Generator: a loss of the same kind
    gen = torch.Generator().manual_seed(0)
    own = loss_cls_3d(torch.from_numpy(feats), torch.from_numpy(probs), gen, k=k,
                      max_points=max_points, sample_size=sample_size)
    assert torch.isfinite(own) and 0.2 * want < float(own) < 5 * want
