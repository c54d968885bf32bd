"""The port's training losses (segsplat_tpu_torch/train/losses.py) against the
JAX package's on the same seeded numpy inputs: 1e-5 relative, exact for labels
and assignments. The contrastive loss is fed the JAX sample indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.train import losses as JL
from segsplat_tpu_torch.train import losses as PL

H, W, D = 24, 32, 16


def _inputs(n_ids: int = 6):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((D, H, W)).astype(np.float32)
    # mask ids in blocks, plus a cluster pulled toward one direction so the
    # confidence map is neither all 0 nor all 1
    gt_obj = (np.arange(H)[:, None] // 6 * 4 + np.arange(W)[None, :] // 8) % n_ids
    feats[:, gt_obj == 0] += 3.0 * rng.standard_normal((D, 1)).astype(np.float32)
    logits = rng.standard_normal((256, H, W)).astype(np.float32)
    img1 = rng.random((3, H, W)).astype(np.float32)
    img2 = np.clip(img1 + 0.1 * rng.standard_normal((3, H, W)), 0, 1).astype(np.float32)
    return feats, gt_obj.astype(np.int32), logits, img1, img2


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=1e-7)


def test_photometric_losses_match_jax():
    _, _, _, a, b = _inputs()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(PL.l1_loss(ta, tb), JL.l1_loss(ja, jb))
    _close(PL.ssim(ta, tb), JL.ssim(ja, jb))
    _close(PL.psnr(ta, tb), JL.psnr(ja, jb))


def test_cluster_stats_and_onehot_match_jax():
    feats, gt_obj, _, _, _ = _inputs()
    f = feats.reshape(D, -1).T
    f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-6)
    lab = gt_obj.reshape(-1)
    np.testing.assert_array_equal(PL._label_onehot(torch.from_numpy(lab)).numpy(),
                                  np.asarray(JL._label_onehot(jnp.asarray(lab))))
    ref = JL._cluster_stats(jnp.asarray(f), jnp.asarray(lab), 10.0, 0.5, 1.0)
    got = PL._cluster_stats(torch.from_numpy(f), torch.from_numpy(lab), 10.0, 0.5, 1.0)
    for g, r in zip(got, ref):
        _close(g, r)


def test_contrastive_loss_matches_jax_with_the_same_samples():
    feats, gt_obj, _, _, _ = _inputs()
    key = jax.random.PRNGKey(3)
    ref_loss, ref_reg = JL.contrastive_loss(jnp.asarray(feats), jnp.asarray(gt_obj), key)
    idx = np.array(jax.random.randint(key, (32768,), 0, H * W))
    got_loss, got_reg = PL.contrastive_loss(torch.from_numpy(feats), torch.from_numpy(gt_obj),
                                            idx=torch.from_numpy(idx).long())
    _close(got_loss, ref_loss)
    _close(got_reg, ref_reg)
    assert float(got_loss) > 0


def test_confidence_and_virtual_gt_match_jax():
    feats, gt_obj, logits, _, _ = _inputs()
    ref_conf = np.asarray(JL.confidence_map(jnp.asarray(feats), jnp.asarray(gt_obj)))
    got_conf = PL.confidence_map(torch.from_numpy(feats), torch.from_numpy(gt_obj)).numpy()
    np.testing.assert_array_equal(got_conf, ref_conf)
    assert 0 < got_conf.mean() < 1

    ref_vgt = np.asarray(JL.virtual_gt_labels(jnp.asarray(gt_obj), jnp.asarray(logits)))
    got_vgt = PL.virtual_gt_labels(torch.from_numpy(gt_obj), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got_vgt, ref_vgt)
    assert len(np.unique(got_vgt)) == len(np.unique(gt_obj))


@pytest.mark.parametrize("match", [False, True])
def test_classification_and_clustering_losses_match_jax(match):
    feats, gt_obj, logits, _, _ = _inputs()
    conf = (np.random.default_rng(1).random((H, W)) < 0.5).astype(np.float32)
    vgt = gt_obj if not match else logits.argmax(0).astype(np.int32)  # match: gate closes
    code_book = np.random.default_rng(2).uniform(-0.25, 0.25, (256, D)).astype(np.float32)
    ref = JL.gated_classification_loss(jnp.asarray(logits), jnp.asarray(vgt),
                                       jnp.asarray(conf), 16)
    got = PL.gated_classification_loss(torch.from_numpy(logits), torch.from_numpy(vgt),
                                       torch.from_numpy(conf), 16)
    _close(got, ref)
    assert (float(got) == 0.0) == match
    ref = JL.clustering_loss(jnp.asarray(feats), jnp.asarray(vgt), jnp.asarray(code_book),
                             jnp.asarray(conf))
    got = PL.clustering_loss(torch.from_numpy(feats), torch.from_numpy(vgt),
                             torch.from_numpy(code_book), torch.from_numpy(conf))
    _close(got, ref)
