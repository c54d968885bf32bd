"""The edit CLI twins of the port against the JAX scripts on one small model
directory (the pseudo-label loop's 5-object scene at 64², Gaussians whose
identity is their object's one-hot, a codebook whose classes are the
objects): edit_object_removal and edit_object_inpaint (without finetune) save
the same PLY, field for field; the inpaint twin's finetune on the CPU moves
only the new rows; inpaint_images with ``--method pushpull`` writes the JAX
script's frames (8-bit, within one level where the float fill rounds the
other way), and with ``--method patch`` keeps the known pixels and fills the
hole."""

import contextlib
import io
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import edit_object_inpaint as jax_inpaint  # noqa: E402
import edit_object_removal as jax_removal  # noqa: E402
import inpaint_images as jax_inpaint_images  # noqa: E402

from segsplat_tpu_torch import edit_object_inpaint, edit_object_removal  # noqa: E402
from segsplat_tpu_torch import inpaint_images  # noqa: E402
from segsplat_tpu_torch import pseudo_label_loop as L  # noqa: E402
from segsplat_tpu_torch.io.ply import load_gaussian_ply, save_gaussian_ply  # noqa: E402
from _torch_port import torch_threads  # noqa: E402

SIZE, FRAMES, ITER, OBJ = 64, 4, 3, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("edit")
    g = L.build_objects(np.random.default_rng(0))
    Rs, ts, fx, fy = L.orbit_cameras(FRAMES, SIZE, SIZE)
    rgbs, gts = L.render_sweep(g, Rs, ts, fx, fy, SIZE, SIZE, device="cpu")
    L.write_colmap_scene(str(root), g, Rs, ts, fx, fy, rgbs)
    n = len(g["xyz"])
    objects = np.zeros((n, 1, 16), np.float32)
    objects[np.arange(n), 0, g["oid"]] = 8.0
    model = root / "model"
    it_dir = model / "point_cloud" / f"iteration_{ITER}"
    it_dir.mkdir(parents=True)
    save_gaussian_ply(str(it_dir / "point_cloud.ply"), xyz=g["xyz"],
                      features_dc=((g["rgb"] - 0.5) / 0.28209479177387814)[:, None, :],
                      features_rest=np.zeros((n, 15, 3), np.float32),
                      opacity=np.log(g["opac"] / (1 - g["opac"]))[:, None],
                      scaling=np.log(g["scales"]), rotation=g["quats"], objects_dc=objects)
    np.savez(it_dir / "classifier.npz", code_book=np.eye(256, 16, dtype=np.float32))
    return dict(root=str(root), model=str(model), gts=gts, oid=g["oid"])


def _model_copy(scene, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(scene["model"], dst)
    return str(dst)


def _ply(model, it):
    return load_gaussian_ply(os.path.join(model, "point_cloud", f"iteration_{it}",
                                          "point_cloud.ply"))


def _same_ply(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_removal_twin_saves_the_jax_ply(scene, tmp_path):
    models = {k: _model_copy(scene, tmp_path, k) for k in ("jax", "port")}
    common = ["-s", scene["root"], "--iteration", str(ITER), "--select_obj_id", str(OBJ), "1"]
    _quiet(jax_removal.main, ["-m", models["jax"], *common])
    out = _quiet(edit_object_removal.main, ["-m", models["port"], *common, "--device", "cpu"])
    got, want = _ply(models["port"], ITER + 1), _ply(models["jax"], ITER + 1)
    _same_ply(got, want)
    removed = int(np.isin(scene["oid"], [OBJ, 1]).sum())
    assert f"removing {removed} gaussians" in out
    assert len(got["xyz"]) == len(scene["oid"]) - removed


def test_inpaint_twin_saves_the_jax_ply_and_finetunes_new_rows(scene, tmp_path):
    models = {k: _model_copy(scene, tmp_path, k) for k in ("jax", "port")}
    common = ["-s", scene["root"], "--iteration", str(ITER), "--select_obj_id", str(OBJ)]
    _quiet(jax_inpaint.main, ["-m", models["jax"], *common])
    out = _quiet(edit_object_inpaint.main, ["-m", models["port"], *common, "--device", "cpu"])
    seeded = _ply(models["port"], ITER + 1)
    _same_ply(seeded, _ply(models["jax"], ITER + 1))
    n_obj = int((scene["oid"] == OBJ).sum())
    assert f"seeded {n_obj} replacement gaussians" in out
    assert len(seeded["xyz"]) == len(scene["oid"])

    # two finetune steps on the CPU: the saved rows are the seeded ones, in
    # the same order; only the rows that replaced the object moved
    _quiet(edit_object_inpaint.main, ["-m", models["port"], *common, "--device", "cpu",
                                      "--finetune_iters", "2", "--out_iteration", "9"])
    tuned = _ply(models["port"], 9)
    new = np.flatnonzero(scene["oid"] == OBJ)       # the freed rows take the new points
    old = np.setdiff1d(np.arange(len(scene["oid"])), new)
    for k in ("xyz", "features_dc", "opacity", "scaling", "rotation", "objects_dc"):
        np.testing.assert_array_equal(tuned[k][old], seeded[k][old], err_msg=k)
        assert np.isfinite(tuned[k]).all()
    np.testing.assert_array_equal(tuned["objects_dc"], seeded["objects_dc"])
    assert np.abs(tuned["xyz"][new] - seeded["xyz"][new]).max() > 0


def _masks(scene, tmp_path):
    images = os.path.join(scene["root"], "images")
    masks = tmp_path / "object_mask"
    masks.mkdir()
    for f, gt in zip(sorted(os.listdir(images)), scene["gts"]):
        Image.fromarray(gt.astype(np.uint8)).save(masks / f)
    return images, str(masks)


def test_inpaint_images_twin(scene, tmp_path):
    images, masks = _masks(scene, tmp_path)
    common = ["--images", images, "--masks", masks, "--select_obj_id", str(OBJ),
              "--dilate", "2", "--smooth_iters", "16"]
    out = {}
    for k, main, extra in (("jax", jax_inpaint_images.main, []),
                           ("port", inpaint_images.main, ["--device", "cpu"])):
        out[k] = str(tmp_path / k)
        _quiet(main, [*common, "--out", out[k], "--method", "pushpull", *extra])
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["port"])) and len(names) == FRAMES
    for f in names:
        got = np.asarray(Image.open(os.path.join(out["port"], f))).astype(int)
        want = np.asarray(Image.open(os.path.join(out["jax"], f))).astype(int)
        assert np.abs(got - want).max() <= 1, f

    patch = str(tmp_path / "patch")
    printed = _quiet(inpaint_images.main, [*common, "--out", patch, "--method", "patch",
                                           "--report_lpips", "--device", "cpu"])
    assert "lins=none backbone=random(seed0)" in printed
    assert printed.count("lpips_vgg=") == FRAMES
    for f, gt in zip(names, scene["gts"]):
        hole = inpaint_images.dilate(gt == OBJ, 2)
        src = np.asarray(Image.open(os.path.join(images, f)).convert("RGB"))
        filled = np.asarray(Image.open(os.path.join(patch, f)))
        np.testing.assert_array_equal(filled[~hole], src[~hole])
        if hole.any():
            assert (filled[hole] != src[hole]).any()
