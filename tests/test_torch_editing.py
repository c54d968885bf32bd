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


# ───────────── removal, inpaint set-up and the masked finetune ─────────────

def _assert_tables_equal(pt, jt):
    for f in dataclasses.fields(jt):
        got, want = getattr(pt, f.name), getattr(jt, f.name)
        if isinstance(want, int) or np.ndim(want) == 0:
            assert int(got) == int(want), f.name
        else:
            got = got.detach().numpy()
            assert got.dtype == np.asarray(want).dtype, f.name
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=f.name)


def test_removal_setup_matches_jax():
    jt, pt, code_book = _tables()
    mask = JE.mask3d_from_classes(jt, code_book, [int(c) for c in
                                                 np.unique(JE.classify_gaussians(jt, code_book))[:4]])
    mask[::7] = True                                # inactive rows in the mask too
    got = TE.removal_setup(pt, mask)
    _assert_tables_equal(got, JE.removal_setup(jt, mask))
    assert int(got.active.sum()) < int(pt.active.sum())
    assert pt.active[np.flatnonzero(mask & np.asarray(jt.active))].all()   # input untouched


# (n live rows, capacity, k, new points, mask): the default set-up, one
# neighbour (cKDTree's flat [N] answer), more new points than free rows, an
# empty mask, and every live row removed (no neighbour left)
SETUP_CASES = {
    "default": (300, 512, 5, None, "box"),
    "k1": (300, 512, 1, None, "box"),
    "no_free_rows": (300, 300, 5, 200, "box"),
    "empty_mask": (300, 512, 5, None, "none"),
    "all_removed": (300, 512, 5, None, "all"),
}


@pytest.mark.parametrize("case", sorted(SETUP_CASES))
def test_inpaint_setup_matches_jax(case):
    n, capacity, k, num_new, how = SETUP_CASES[case]
    jt, pt, _ = _tables(n=n, capacity=capacity, seed=4)
    xyz = np.asarray(jt.xyz)
    mask = {"box": (xyz[:, 0] > 0.3) & (xyz[:, 1] < 0.5), "none": np.zeros(capacity, bool),
            "all": np.ones(capacity, bool)}[how]
    got, got_new = TE.inpaint_setup(pt, mask, num_new_points=num_new, k=k, seed=3)
    want, want_new = JE.inpaint_setup(jt, mask, num_new_points=num_new, k=k, seed=3)
    _assert_tables_equal(got, want)
    np.testing.assert_array_equal(got_new, want_new)
    if how == "box":
        assert got_new.any() and not (got_new & np.asarray(jt.active) & ~mask).any()
        if case == "no_free_rows":                  # only the removed rows are free
            assert got_new.sum() == (mask & np.asarray(jt.active)).sum() < num_new
    else:
        assert not got_new.any()


def test_finetune_grad_mask():
    rows = np.zeros(6, bool)
    rows[[1, 4]] = True
    params = {"xyz": torch.ones(6, 3, requires_grad=True),
              "opacity": torch.ones(6, 1, requires_grad=True),
              "objects_dc": torch.ones(6, 1, 16, requires_grad=True),
              "scaling": torch.ones(6, 3, requires_grad=True)}
    (params["xyz"].sum() * 2 + params["opacity"].sum() + params["objects_dc"].sum()).backward()
    TE.finetune_grad_mask(rows)(params)
    np.testing.assert_array_equal(params["xyz"].grad.numpy(), np.where(rows, 2.0, 0.0)[:, None]
                                  .repeat(3, 1))
    np.testing.assert_array_equal(params["opacity"].grad.numpy()[:, 0], rows.astype(np.float32))
    assert not params["objects_dc"].grad.any()
    assert params["scaling"].grad is None           # untouched where no gradient exists


FT_STEPS = 3


def _finetune_scene():
    """A JAX table of 300 Gaussians in front of tests/_torch_port's camera, an
    object (x > 0.4) removed and re-seeded by ``inpaint_setup``, the camera
    in both packages and a seeded target image."""
    import math

    from segsplat_tpu.core.types import Camera as JaxCamera
    from segsplat_tpu.train import trainer as JT
    from segsplat_tpu_torch.core.types import Camera
    from _torch_port import F, H, W

    rng = np.random.default_rng(0)
    n, cap = 300, 384
    pts = (rng.random((n, 3)) * np.array([3.0, 2.0, 2.0]) + np.array([-1.5, -1.0, 1.5])
           ).astype(np.float32)
    table = JT.init_table_from_pcd(pts, rng.random((n, 3)).astype(np.float32), cap)
    table = dataclasses.replace(
        table, active_sh_degree=jnp.asarray(1, jnp.int32),
        scaling=table.scaling + jnp.asarray(rng.normal(0, 0.3, (cap, 3)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(cap, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(0, 1, (cap, 1)), jnp.float32))
    mask = np.zeros(cap, bool)
    mask[:n] = pts[:, 0] > 0.4
    jt, new_rows = JE.inpaint_setup(table, mask, seed=1)
    fields = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)}
    pt = table_from_jax_arrays(fields, device="cpu")
    fov_x, fov_y = 2 * math.atan(W / (2 * F)), 2 * math.atan(H / (2 * F))
    R = np.eye(3, dtype=np.float32)
    T = np.array([0.05, -0.02, 0.1], np.float32)
    jcam = JaxCamera(R=jnp.asarray(R), T=jnp.asarray(T), fov_x=jnp.asarray(fov_x),
                     fov_y=jnp.asarray(fov_y), width=W, height=H)
    pcam = Camera(R=torch.from_numpy(R), T=torch.from_numpy(T), fov_x=torch.tensor(fov_x),
                  fov_y=torch.tensor(fov_y), width=W, height=H)
    gt = rng.random((3, H, W)).astype(np.float32)
    return jt, pt, new_rows, jcam, pcam, gt


def test_masked_finetune_matches_jax():
    """FT_STEPS steps of the inpaint twin's finetune (MaskedFinetune on the
    dense blend) against scripts/edit_object_inpaint.py's step on ``"xla"``:
    losses at 1e-5, every parameter at 1e-6, the frozen rows and all of
    ``objects_dc`` exactly as they were, the new rows moved."""
    import optax

    from segsplat_tpu.render import render as jax_render
    from segsplat_tpu.train import losses as JL
    from segsplat_tpu.train.trainer import table_params, with_params
    from segsplat_tpu_torch.edit_object_inpaint import MaskedFinetune
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    jt, pt, new_rows, jcam, pcam, gt = _finetune_scene()
    assert 0 < new_rows.sum() < 300
    mask_fn = JE.finetune_grad_mask(new_rows)
    opt = optax.adam(1.6e-4, eps=1e-15)
    params = table_params(jt)
    opt_state = opt.init(params)
    gt_j = jnp.asarray(gt)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            out = jax_render(with_params(jt, p), jcam, jnp.zeros((3,)))
            return 0.8 * JL.l1_loss(out["render"], gt_j) + 0.2 * (1.0 - JL.ssim(out["render"],
                                                                                gt_j))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(mask_fn(grads), opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    ft = MaskedFinetune(pt, new_rows, "dense")
    for _ in range(FT_STEPS):
        params, opt_state, loss = step(params, opt_state)
        got_loss = ft.step(pcam, torch.from_numpy(gt))
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    frozen = ~new_rows
    for f in PARAM_FIELDS:
        got, want = ft.params[f].detach().numpy(), np.asarray(params[f])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)
        before = getattr(pt, f).numpy()
        np.testing.assert_array_equal(got[frozen], before[frozen], err_msg=f)
        if f == "objects_dc":
            np.testing.assert_array_equal(got, before)
        elif f != "features_rest":                  # SH degree 1 moves only some bands
            assert np.abs(got[new_rows] - before[new_rows]).max() > 1e-5, f
