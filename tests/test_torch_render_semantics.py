"""The whole slice: the port's render CLI (segsplat_tpu_torch/render_semantics_logits.py,
--device cpu) against the JAX CLI (render_semantics_logits.py, --backend pallas
in interpret mode) on one tiny model dir, and render_semantics_many of both."""

import dataclasses
import os
import shutil
import sys
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_VIEWS, SIZE, N_GAUSS = 3, 32, 80


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A Blender scene of 3 views at 32×32 and a model dir holding a PLY written
    by the port's io/ply.py and a 3-prompt semantics .npz — no training."""
    from segsplat_tpu_torch.io.artifacts import save_semantics
    from segsplat_tpu_torch.io.ply import save_gaussian_ply

    root = tmp_path_factory.mktemp("torch_render")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(N_VIEWS):
        ang = 2 * np.pi * i / N_VIEWS
        pos = np.array([3 * np.sin(ang), 0.0, 3 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, pos
        c2w[:3, 1:3] *= -1
        Image.fromarray((rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)).save(
            root / f"r_{i}.png")
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    import json
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)

    n = N_GAUSS
    model = root / "model"
    save_gaussian_ply(str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
                      xyz=rng.uniform(-1, 1, (n, 3)),
                      features_dc=rng.normal(size=(n, 1, 3)),
                      features_rest=np.zeros((n, 15, 3)),
                      opacity=rng.normal(0.5, 1.0, (n, 1)),
                      scaling=rng.normal(-2.3, 0.3, (n, 3)),
                      rotation=rng.normal(size=(n, 4)))
    sem = root / "gaussian_semantics.npz"
    logits = (rng.standard_normal((n, 3)) * 2).astype(np.float32)
    save_semantics(str(sem), labels=logits.argmax(1), logits=logits,
                   prompts=["wall", "chair", "floor"])
    with open(model / "cfg_args", "w") as f:
        f.write(repr(Namespace(source_path=str(root), model_path=str(model),
                               images="images", object_path="object_mask",
                               resolution=-1, white_background=False, sh_degree=3,
                               eval=False, train_split=False, data_device="cuda",
                               n_views=0, random_init=False, train_test_exp=False)))
    return root, model, sem


def test_cli_artifacts_match_jax(model_dir, monkeypatch, tmp_path):
    import render_semantics_logits as jax_cli

    from segsplat_tpu_torch import render_semantics_logits as torch_cli
    from segsplat_tpu_torch.io.artifacts import load_label_map

    root, model, sem = model_dir
    stdout = sys.stdout
    outs = {}
    for name in ("jax", "torch"):
        monkeypatch.setattr(sys, "stdout", stdout)     # each CLI wraps stdout
        m = tmp_path / f"model_{name}"
        shutil.copytree(model, m)
        argv = ["--model_path", str(m), "--iteration", "1", "--semantics", str(sem),
                "--skip_test"]
        if name == "jax":
            with pltpu.force_tpu_interpret_mode():
                jax_cli.main(argv + ["--backend", "pallas"])
        else:
            torch_cli.main(argv + ["--device", "cpu"])
        outs[name] = m / "train" / "ours_1" / "semantics"

    names = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["torch"])) == names
    for i in range(N_VIEWS):
        stem = f"{i:05d}"
        ref = np.load(outs["jax"] / f"{stem}_logits.npy").astype(np.float32)
        got = np.load(outs["torch"] / f"{stem}_logits.npy").astype(np.float32)
        assert ref.shape == (3, SIZE, SIZE) and np.abs(ref).max() > 0.1
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)   # fp16 files
        top2 = np.sort(ref, axis=0)[-2:]
        clear = (top2[1] - top2[0]) > 1e-3
        assert clear.mean() > 0.5                    # background pixels tie at 0
        j_lab = load_label_map(str(outs["jax"] / f"{stem}_labels.pt"))
        t_lab = load_label_map(str(outs["torch"] / f"{stem}_labels.pt"))
        np.testing.assert_array_equal(t_lab[clear], j_lab[clear])
        for suffix in ("_mask_color.png", "_confidence.png"):
            assert (outs["torch"] / f"{stem}{suffix}").exists()


def test_render_semantics_many_matches_jax(model_dir):
    from segsplat_tpu.render import render_semantics_many as jax_many
    from segsplat_tpu.scene import Scene as JaxScene
    from segsplat_tpu.scene import to_device_camera as jax_camera
    from segsplat_tpu_torch.pipeline.render_semantics import attach_logits_for_table
    from segsplat_tpu_torch.render import render_semantics, render_semantics_many
    from segsplat_tpu_torch.scene import Scene, to_device_camera

    root, model, sem = model_dir
    jscene = JaxScene(str(root), str(model), shuffle=False, load_iteration=1)
    tscene = Scene(str(root), str(model), shuffle=False, load_iteration=1, device="cpu")
    jt, tt = jscene.gaussians, tscene.gaussians
    for f in dataclasses.fields(tt):       # the port's loader gives the same table
        np.testing.assert_array_equal(np.asarray(getattr(tt, f.name)),
                                      np.asarray(getattr(jt, f.name)), err_msg=f.name)
    logits = attach_logits_for_table(tt, str(sem))
    kw = dict(max_tiles_per_axis=6, max_per_tile=256, pair_cap=4000, view_batch=2)
    with pltpu.force_tpu_interpret_mode():
        ref = [(i, np.asarray(s), aux) for i, s, aux in jax_many(
            jt, [jax_camera(c) for c in jscene.get_train_cameras()],
            jnp.asarray(logits), backend="pallas", **kw)]
    got = list(render_semantics_many(
        tt, [to_device_camera(c, device="cpu") for c in tscene.get_train_cameras()],
        torch.from_numpy(logits), **kw))
    assert [i for i, _, _ in got] == [i for i, _, _ in ref] == list(range(N_VIEWS))
    for (_, g, g_aux), (_, r, r_aux) in zip(got, ref):
        assert g.shape == r.shape == (32, SIZE, SIZE)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4)
        assert g_aux == r_aux
    one, aux = render_semantics(tt, to_device_camera(tscene.get_train_cameras()[0],
                                                     device="cpu"),
                                torch.from_numpy(logits), return_aux=True, **{
                                    k: v for k, v in kw.items() if k != "view_batch"})
    assert torch.equal(one, got[0][1])
    assert {k: int(v) for k, v in aux.items()} == got[0][2]


def test_render_semantic_views_dense_backend(model_dir, tmp_path):
    """The pipeline on the dense backend (the JAX package's "xla"): no
    automatic pair_cap, and the same logits as JAX render_semantics_many."""
    from segsplat_tpu.render import render_semantics_many as jax_many
    from segsplat_tpu.scene import Scene as JaxScene
    from segsplat_tpu.scene import to_device_camera as jax_camera
    from segsplat_tpu_torch.pipeline.render_semantics import (attach_logits_for_table,
                                                              render_semantic_views)
    from segsplat_tpu_torch.scene import Scene, to_device_camera

    root, model, sem = model_dir
    jscene = JaxScene(str(root), str(model), shuffle=False, load_iteration=1)
    tscene = Scene(str(root), str(model), shuffle=False, load_iteration=1, device="cpu")
    logits = attach_logits_for_table(tscene.gaussians, str(sem))
    ref = [np.asarray(s) for _, s, _ in jax_many(
        jscene.gaussians, [jax_camera(c) for c in jscene.get_train_cameras()],
        jnp.asarray(logits), backend="xla", max_tiles_per_axis=6, max_per_tile=256)]
    labels = render_semantic_views(
        tscene.gaussians, [to_device_camera(c, device="cpu")
                           for c in tscene.get_train_cameras()],
        logits, str(tmp_path), backend="dense")
    assert len(labels) == len(ref) == N_VIEWS
    for i, r in enumerate(ref):
        got = np.load(tmp_path / f"{i:05d}_logits.npy").astype(np.float32)
        np.testing.assert_allclose(got, r[:3], atol=1e-3, rtol=0)   # fp16 files
