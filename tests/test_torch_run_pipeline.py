"""The port's one-command pipeline (``python -m segsplat_tpu_torch.run_pipeline``)
on the CPU over a tiny trained scene, against the JAX run_pipeline.py on the
same inputs, as tests/test_cli_e2e.py::test_run_pipeline_end_to_end builds
them: 3 views of 32×32, the port's 4 training iterations, 8-channel 16×16
stub LSeg maps and the camera JSON of the Blender frames.

Tolerances: the grid PLYs' centres equal; voxel features, semantics and grid
through eval/parity's own (features rtol/atol 2e-3, logits 5e-3, labels and
voxel sets < 1 % apart); the 1-NN map equal to JAX's or within the tie bound of
tests/_torch_port.nn_index_mismatch."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from segsplat_tpu_torch import run_pipeline
from segsplat_tpu_torch.eval import parity
from segsplat_tpu_torch.io.artifacts import load_label_map, load_voxel_features, save_semantics
from segsplat_tpu_torch.io.dataset import store_point_cloud_ply
from segsplat_tpu_torch.io.provenance import RANDOM, write_provenance
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply
from segsplat_tpu_torch.pipeline.train import TrainRunConfig, train
from segsplat_tpu_torch.train.trainer import OptimizationConfig
from segsplat_tpu_torch.utils.config import save_cfg_args
from tests._torch_port import blender_to_camera_json, nn_index_mismatch, write_seeded_maps

PROMPTS = ["wall", "chair"]
GRID_ARGS = ["--cell_size", "0.3", "--density_eps", "0.8", "--density_min_neighbors", "1"]


@pytest.fixture(scope="module")
def pipeline_scene(tmp_path_factory):
    """tests/test_cli_e2e.py's trained_scene, trained by the port on the CPU,
    with its stub LSeg maps and camera JSON."""
    import json
    from argparse import Namespace

    root = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        pos = np.array([3 * np.sin(ang), 0.0, 3 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, pos
        c2w[:3, 1:3] *= -1
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
            root / f"r_{i}.png")
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    xyz = (rng.random((80, 3)) * 2 - 1).astype(np.float32)
    store_point_cloud_ply(str(root / "points3d.ply"), xyz,
                          (rng.random((80, 3)) * 255).astype(np.uint8))
    model = str(root / "model")
    opt = OptimizationConfig(iterations=4, densify_from_iter=99, densify_until_iter=0,
                             num_classes=16)
    run = TrainRunConfig(iterations=4, test_iterations=(), save_iterations=(4,),
                         checkpoint_iterations=(), sh_up_every=99, log_every=2,
                         num_classes=16, raster_max_tiles_per_axis=4,
                         raster_max_per_tile=64, raster_tile_chunk=4)
    train(str(root), model, opt=opt, run=run, capacity=128, device="cpu")
    save_cfg_args(model, Namespace(
        source_path=str(root), model_path=model, images="images",
        object_path="object_mask", resolution=-1, white_background=False,
        sh_degree=3, eval=False))
    cams = str(root / "cams.json")
    names = blender_to_camera_json(str(root / "transforms_train.json"), cams,
                                   [20.0, 20.0, 16.0, 16.0])
    write_seeded_maps(str(root / "lseg"), names, 8, 16, 16)
    return dict(root=str(root), model=model, lseg=str(root / "lseg"), cams=cams)


def _argv(sc, work, *extra):
    return ["-s", sc["root"], "-m", sc["model"], "--iteration", "4", "--lseg_dir", sc["lseg"],
            "--camera_params", sc["cams"], "--prompt", *PROMPTS, *GRID_ARGS,
            "--work_dir", work, *extra]


def _run_port(argv):
    stdout = sys.stdout             # the render CLI's safe_state timestamps stdout
    try:
        return run_pipeline.main(argv)
    finally:
        sys.stdout = stdout


@pytest.fixture(scope="module")
def jax_work(pipeline_scene, tmp_path_factory):
    import run_pipeline as jax_run_pipeline

    work = str(tmp_path_factory.mktemp("jax_work"))
    jax_run_pipeline.main(_argv(pipeline_scene, work, "--skip_render"))
    return work


def _one(work, pattern):
    import glob

    hits = sorted(glob.glob(os.path.join(work, pattern)))
    assert len(hits) == 1, hits
    return hits[0]


def _assert_ok(reports):
    assert all(r.ok for r in reports), [r.line() for r in reports]


def test_run_pipeline_matches_jax(pipeline_scene, jax_work, tmp_path):
    """All five stages on the CPU (stage 5 on the dense blend), with
    --parity_dir on the JAX run's work dir; every artifact against JAX's."""
    work = str(tmp_path / "work")
    out = _run_port(_argv(pipeline_scene, work, "--device", "cpu", "--render_backend",
                          "dense", "--parity_dir", jax_work))
    assert set(out["timing"]) == {"voxel_grid", "lift", "centers_map", "query", "render"}

    grid, jgrid = out["grid_ply"], _one(jax_work, "grid_*vox.ply")
    assert os.path.basename(grid) == os.path.basename(jgrid)
    ca, _, vsa, oa, _ = read_voxel_grid_ply(grid)
    cb, _, vsb, ob, _ = read_voxel_grid_ply(jgrid)
    np.testing.assert_array_equal(ca, cb)
    assert vsa == vsb == 0.3
    _assert_ok(parity.compare_voxel_grids(grid, jgrid))

    vox = out["voxel_features"]
    jvox = _one(jax_work, "ALL_nonzero_voxel_features_*vox.pt")
    assert os.path.basename(vox) == os.path.basename(jvox)
    _assert_ok(parity.compare_voxel_features(vox, jvox))

    g2v, jg2v = np.load(os.path.join(work, "gauss2voxel.npy")), np.load(
        os.path.join(jax_work, "gauss2voxel.npy"))
    mu = np.load(os.path.join(work, "gaussian_mu.npy"))
    np.testing.assert_array_equal(mu, np.load(os.path.join(jax_work, "gaussian_mu.npy")))
    assert g2v.dtype == jg2v.dtype == np.int64
    nn_index_mismatch(mu, load_voxel_features(vox)["pos"], g2v, jg2v)

    sem = out["semantics"]
    _assert_ok(parity.compare_semantics(sem, os.path.join(jax_work, "gaussian_semantics.npz")))
    labels = np.load(sem)["labels"]
    assert labels.min() >= 0 and labels.max() < len(PROMPTS)
    for suffix in ("_gaussians.ply", "_voxels.ply"):
        assert os.path.exists(sem.replace(".npz", suffix))

    out_dir = os.path.join(pipeline_scene["model"], "train", "ours_4", "semantics")
    for i in range(3):
        lab = load_label_map(os.path.join(out_dir, f"{i:05d}_labels.pt"))
        assert lab.shape == (32, 32) and lab.min() >= 0 and lab.max() < len(PROMPTS)
        logits = np.load(os.path.join(out_dir, f"{i:05d}_logits.npy"))
        assert logits.shape == (len(PROMPTS), 32, 32) and np.isfinite(logits).all()


def test_run_pipeline_parity_dir_fails_on_a_differing_artifact(pipeline_scene, jax_work,
                                                               tmp_path):
    ref = tmp_path / "ref"
    ref.mkdir()
    d = np.load(os.path.join(jax_work, "gaussian_semantics.npz"))
    save_semantics(str(ref / "gaussian_semantics.npz"), (d["labels"] + 1) % len(PROMPTS),
                   d["logits"] + 1.0, PROMPTS)
    with pytest.raises(SystemExit, match="PARITY"):
        _run_port(_argv(pipeline_scene, str(tmp_path / "work"), "--device", "cpu",
                        "--skip_render", "--parity_dir", str(ref)))


def test_run_pipeline_refuses_random_weight_features(pipeline_scene, tmp_path):
    """Stage 2 refuses a feature directory stamped weights_source=random, as
    the JAX pipeline does, and writes no semantics."""
    lseg = str(tmp_path / "lseg")
    shutil.copytree(pipeline_scene["lseg"], lseg)
    write_provenance(lseg, RANDOM, stage="extract_lseg_features")
    work = str(tmp_path / "work")
    with pytest.raises(RuntimeError, match="RANDOM weights"):
        _run_port(_argv(dict(pipeline_scene, lseg=lseg), work, "--device", "cpu"))
    assert not os.path.exists(os.path.join(work, "gaussian_semantics.npz"))


def test_run_pipeline_defaults_to_cuda(pipeline_scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_pipeline.main(_argv(pipeline_scene, str(tmp_path / "work")))
    assert not os.path.exists(tmp_path / "work")
