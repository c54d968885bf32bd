"""The port's training orchestration (segsplat_tpu_torch/pipeline/train.py) and
its CLI twin (``python -m segsplat_tpu_torch.train``) on the tiny Blender-style
scene of tests/test_train_pipeline.py, on the CPU, with that test's schedule:
densify, opacity reset, SH bump, eval, save, checkpoint and resume. The saved
PLY must load through the JAX package's ``load_gaussian_table`` into the same
active rows and features."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from segsplat_tpu.scene import load_gaussian_table as jax_load_gaussian_table
from segsplat_tpu_torch.io.dataset import store_point_cloud_ply
from segsplat_tpu_torch.pipeline.train import TrainRunConfig, raster_kw_for, train
from segsplat_tpu_torch.train.cli import main as cli_main
from segsplat_tpu_torch.train.densify import PARAM_FIELDS
from segsplat_tpu_torch.train.trainer import OptimizationConfig


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """tests/test_train_pipeline.py's scene: 3 views of 32×32 around the
    origin, 96 random points."""
    root = tmp_path_factory.mktemp("blender")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        pos = np.array([3 * np.sin(ang), 0.0, 3 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right = right / np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, pos
        c2w[:3, 1:3] *= -1
        Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
            root / f"r_{i}.png")
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    xyz = (rng.random((96, 3)) * 2 - 1).astype(np.float32)
    store_point_cloud_ply(str(root / "points3d.ply"), xyz,
                          (rng.random((96, 3)) * 255).astype(np.uint8))
    return str(root)


OPT = OptimizationConfig(iterations=12, densify_from_iter=4, densify_until_iter=10,
                         densification_interval=5, opacity_reset_interval=8,
                         num_classes=16, densify_grad_threshold=1e-7)
RASTER = dict(num_classes=16, raster_max_tiles_per_axis=4, raster_max_per_tile=128)


def test_train_with_full_schedule_saves_and_resumes(blender_scene, tmp_path):
    model_path = str(tmp_path / "model")
    run = TrainRunConfig(iterations=12, test_iterations=(12,), save_iterations=(12,),
                         checkpoint_iterations=(12,), sh_up_every=6, log_every=2, **RASTER)
    records = []
    state = train(blender_scene, model_path, opt=OPT, run=run, capacity=192,
                  progress_cb=records.append, device="cpu")
    assert state.step == 12 and state.table.active_sh_degree == 2
    # the densify step at 5 cloned or split: more active rows than points
    assert int(state.table.active.sum()) > 96
    ply = os.path.join(model_path, "point_cloud", "iteration_12", "point_cloud.ply")
    assert os.path.exists(os.path.join(model_path, "point_cloud", "iteration_12",
                                       "classifier.npz"))
    assert os.path.exists(os.path.join(model_path, "cameras.json"))
    metrics = [json.loads(line) for line in open(os.path.join(model_path, "metrics.jsonl"))]
    steps = [m for m in metrics if "total" in m]
    assert [m["iter"] for m in steps] == [2, 4, 6, 8, 10, 12]
    assert all(np.isfinite(m[k]) for m in steps for k in ("total", "l1", "psnr"))
    assert any("eval_psnr" in m and np.isfinite(m["eval_psnr"]) for m in metrics)
    assert records == steps

    # the JAX package reads the port's PLY into the same active rows
    jt = jax_load_gaussian_table(ply, max_sh_degree=3)
    active = state.table.active.numpy()
    n = int(active.sum())
    assert int(np.asarray(jt.active).sum()) == n
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f))[:n],
                                      getattr(state.table, f).detach().numpy()[active],
                                      err_msg=f)

    # resume from the checkpoint for two more steps
    ckpt = os.path.join(model_path, "chkpnts", "chkpnt12.pt")
    run2 = TrainRunConfig(iterations=14, test_iterations=(), save_iterations=(),
                          checkpoint_iterations=(), sh_up_every=6, log_every=2, **RASTER)
    state2 = train(blender_scene, str(tmp_path / "model2"), opt=OPT, run=run2,
                   capacity=192, start_checkpoint=ckpt, device="cpu")
    assert state2.step == 14 and state2.table.active_sh_degree == 2
    assert torch.equal(state2.table.active, state.table.active)


def test_scene_from_point_cloud_and_auto_k_match_jax(blender_scene, tmp_path):
    """The point-cloud branch of Scene (table, cameras.json) and the auto-sized
    per-tile K, against the JAX package's on the same scene."""
    from segsplat_tpu.pipeline.train import TrainRunConfig as JaxRun
    from segsplat_tpu.pipeline.train import _resolve_auto_max_per_tile as jax_auto_k
    from segsplat_tpu.scene import Scene as JaxScene
    from segsplat_tpu_torch.pipeline.train import _resolve_auto_max_per_tile
    from segsplat_tpu_torch.scene import Scene

    js = JaxScene(blender_scene, str(tmp_path / "jax"), capacity=192, seed=0)
    ps = Scene(blender_scene, str(tmp_path / "port"), capacity=192, seed=0, device="cpu")
    assert ps.cameras_extent == js.cameras_extent
    assert [c.image_name for c in ps.get_train_cameras()] == \
        [c.image_name for c in js.get_train_cameras()]
    for name in ("cameras.json", "input.ply"):
        with open(tmp_path / "jax" / name, "rb") as a, open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(ps.gaussians, f).numpy(),
                                   np.asarray(getattr(js.gaussians, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    for m in (2, 4):
        kw = dict(num_classes=16, raster_max_tiles_per_axis=m, raster_max_per_tile=0)
        ref = jax_auto_k(js, js.gaussians, JaxRun(**kw))
        assert _resolve_auto_max_per_tile(ps, ps.gaussians, TrainRunConfig(**kw),
                                          "cpu") == ref


def test_train_states_its_limits(blender_scene, tmp_path):
    for kw in (dict(view_batch=2), dict(mesh_tensor=2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            train(blender_scene, str(tmp_path / "m"), opt=OPT,
                  run=TrainRunConfig(iterations=1, **kw), device="cpu")
    # K = 64 is no multiple of the kernels' 128-row block, and trains on them
    # (their plain versions here) and on the dense blend; the JAX package's
    # "auto"/"xla" names are no backend of the port
    for backend in ("cuda", "dense"):
        run = TrainRunConfig(iterations=1, test_iterations=(), save_iterations=(),
                             checkpoint_iterations=(), log_every=1, num_classes=16,
                             raster_max_tiles_per_axis=4, raster_max_per_tile=64,
                             raster_backend=backend)
        assert raster_kw_for(run)["backend"] == backend
        state = train(blender_scene, str(tmp_path / f"k64_{backend}"), opt=OPT, run=run,
                      device="cpu")
        assert state.step == 1
        rec = json.loads(open(tmp_path / f"k64_{backend}" / "metrics.jsonl").readline())
        assert np.isfinite(rec["total"])
    for backend in ("auto", "xla"):
        with pytest.raises(ValueError, match="raster_backend"):
            train(blender_scene, str(tmp_path / "m"), opt=OPT,
                  run=TrainRunConfig(iterations=1, raster_backend=backend), device="cpu")


def test_cli_twin_trains_on_the_cpu(blender_scene, tmp_path, monkeypatch):
    import sys

    model_path = str(tmp_path / "cli")
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the CLI timestamps stdout
    state = cli_main(["-s", blender_scene, "-m", model_path, "--iterations", "3",
                      "--capacity", "192", "--num_classes", "16", "--test_iterations", "3",
                      "--checkpoint_iterations", "3", "--device", "cpu", "--quiet"])
    assert state.step == 3
    assert os.path.exists(os.path.join(model_path, "point_cloud", "iteration_3",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(model_path, "cfg_args"))
    with pytest.raises(NotImplementedError, match="viewer"):
        cli_main(["-s", blender_scene, "-m", model_path, "--port", "6009",
                  "--device", "cpu"])
