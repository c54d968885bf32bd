"""The pipeline entry points over several ranks, on the CPU (the port's
counterpart of tests/test_parallel_cli.py). Ranks run as gloo processes of this
file (``python tests/test_torch_parallel_cli.py worker MODE ...``, launched by
``_torch_port.run_ranks``); each rank gets its own output path, so that a file
written by a rank other than 0 would show.

  * ``pipeline/train.train(view_batch=2)`` at world 2 against world 1 (no
    process group), with a densify step and a checkpoint: xyz rtol 1e-4,
    atol 1e-5; both ranks' tables the same bits; only rank 0's model dir
    exists; a resume at world 2 from rank 0's checkpoint, which rank 1 never
    reads;
  * the aggregation CLI twin at ``--mesh_view 2`` against the single-device
    run, both methods: the artifacts equal in their fp16 files; only rank 0's
    files exist.
"""

import json
import os
import sys

import numpy as np
import pytest

from _torch_port import run_ranks, worker_main

HERE = os.path.abspath(__file__)
LIFT_METHODS = ("splat", "dda")


def _train_config(iterations: int):
    from segsplat_tpu_torch.pipeline.train import TrainRunConfig
    from segsplat_tpu_torch.train.trainer import OptimizationConfig

    opt = OptimizationConfig(iterations=iterations, densify_from_iter=1,
                             densification_interval=2, densify_until_iter=4,
                             opacity_reset_interval=100, densify_grad_threshold=1e-7,
                             num_classes=16)
    run = TrainRunConfig(iterations=iterations, test_iterations=(), save_iterations=(4,),
                         checkpoint_iterations=(4,), sh_up_every=99, log_every=1,
                         num_classes=16, raster_max_tiles_per_axis=4, raster_max_per_tile=64,
                         raster_tile_chunk=4, view_batch=2)
    return opt, run


def _train(scene: str, model: str, iterations: int = 4, start_checkpoint=None):
    from segsplat_tpu_torch.pipeline.train import train

    opt, run = _train_config(iterations)
    return train(scene, model, opt=opt, run=run, capacity=128,
                 start_checkpoint=start_checkpoint, device="cpu")


def _lift_argv(inputs: dict, out_dir: str, method: str):
    return ["--voxel_ply", inputs["grid_ply"], "--lseg_dir", inputs["lseg"],
            "--camera_params", inputs["cam_json"], "--out_dir", out_dir,
            "--downsample_factor", "1.0", "--view_chunk", "3", "--max_views", "8",
            "--checkpoint_every", "4", "--depth_max", "6.0", "--method", method,
            "--device", "cpu"]


# ───────────────────────────── the ranks' work ─────────────────────────────

def train_ranks(rank, world, workdir, scene):
    model = os.path.join(workdir, f"model_r{rank}")
    state = _train(scene, model)
    np.savez(os.path.join(workdir, f"train_rank{rank}.npz"),
             xyz=state.table.xyz.detach().numpy(), active=state.table.active.numpy())
    # a resume: rank 0 reads its checkpoint and broadcasts it; rank 1's path
    # does not exist
    ckpt = os.path.join(workdir, "model_r0", "chkpnts", "chkpnt4.pt")
    state = _train(scene, os.path.join(workdir, f"resumed_r{rank}"), iterations=5,
                   start_checkpoint=ckpt if rank == 0 else ckpt + ".absent")
    np.savez(os.path.join(workdir, f"resumed_rank{rank}.npz"),
             xyz=state.table.xyz.detach().numpy(), step=state.step)


def lift_ranks(rank, world, workdir, inputs_json):
    from segsplat_tpu_torch.aggregate_voxel_features_onthefly import main

    inputs = json.loads(inputs_json)
    for method in LIFT_METHODS:
        main(_lift_argv(inputs, os.path.join(workdir, f"lift_{method}_r{rank}"), method)
             + ["--mesh_view", "2"])


WORKERS = {"train": train_ranks, "lift": lift_ranks}


# ───────────────────────────── training ─────────────────────────────

@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """tests/test_parallel_cli.py's scene: 4 views of 32×32 around the origin,
    64 random points."""
    from PIL import Image

    from segsplat_tpu_torch.io.dataset import store_point_cloud_ply

    root = tmp_path_factory.mktemp("scene_pcli")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(4):
        ang = 2 * np.pi * i / 4
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
    store_point_cloud_ply(str(root / "points3d.ply"),
                          (rng.random((64, 3)) * 2 - 1).astype(np.float32),
                          (rng.random((64, 3)) * 255).astype(np.uint8))
    return str(root)


def test_train_view_batch_at_world_2_matches_world_1(blender_scene, tmp_path):
    run_ranks(HERE, "train", 2, tmp_path, blender_scene)
    ref = _train(blender_scene, str(tmp_path / "world1"))
    assert ref.step == 4 and int(ref.table.active.sum()) > 64, "the densify step must add rows"
    ranks = [dict(np.load(tmp_path / f"train_rank{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["active"], ref.table.active.numpy())
    np.testing.assert_allclose(ranks[0]["xyz"], ref.table.xyz.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    for k in ("xyz", "active"):
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    # rank 0 writes the model dir; rank 1 writes nothing
    model = tmp_path / "model_r0"
    assert (model / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
    assert (model / "point_cloud" / "iteration_4" / "classifier.npz").exists()
    assert (model / "chkpnts" / "chkpnt4.pt").exists() and (model / "cameras.json").exists()
    steps = [json.loads(line) for line in open(model / "metrics.jsonl")]
    assert [m["iter"] for m in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(m["total"]) for m in steps)
    assert not (tmp_path / "model_r1").exists() and not (tmp_path / "resumed_r1").exists()
    resumed = [dict(np.load(tmp_path / f"resumed_rank{r}.npz")) for r in range(2)]
    assert int(resumed[0]["step"]) == int(resumed[1]["step"]) == 5
    np.testing.assert_array_equal(resumed[1]["xyz"], resumed[0]["xyz"])


def test_mixed_resolutions_fall_back_to_single_view_steps(blender_scene, tmp_path, capsys):
    """As the JAX package: a view batch needs one resolution; otherwise the run
    warns in its words and trains one view a step."""
    import shutil

    from PIL import Image

    scene = tmp_path / "mixed"
    shutil.copytree(blender_scene, scene)
    img = Image.open(scene / "r_1.png")
    img.resize((48, 32)).save(scene / "r_1.png")
    state = _train(str(scene), str(tmp_path / "model"), iterations=2)
    assert state.step == 2
    assert ("[WARN] view_batch>1 requires uniform camera resolutions; falling back to "
            "single-view steps") in capsys.readouterr().out


# ───────────────────────────── the lift CLI ─────────────────────────────

@pytest.fixture(scope="module")
def lift_inputs(tmp_path_factory):
    """tests/test_parallel_cli.py's lift inputs: a 5³ grid PLY at 0.25, 8
    seeded [6, 16, 16] fp16 maps and a ring of cameras."""
    from segsplat_tpu_torch.io.ply import write_voxel_grid_ply

    root = tmp_path_factory.mktemp("liftcli")
    rng = np.random.default_rng(0)
    vs = 0.25
    ii = np.stack(np.meshgrid(*([np.arange(5)] * 3), indexing="ij"), axis=-1).reshape(-1, 3)
    origin = np.array([-0.5, -0.5, -0.5], np.float32)
    centers = (origin + ii * vs).astype(np.float32)
    grid_ply = str(root / "grid.ply")
    write_voxel_grid_ply(grid_ply, centers, np.full((len(centers), 3), 128, np.uint8), vs,
                         origin)
    images, lseg = {}, root / "lseg"
    lseg.mkdir()
    for i in range(8):
        ang = 2 * np.pi * i / 8
        pos = np.array([2.5 * np.sin(ang), 0.0, -2.5 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, pos
        w2c = np.linalg.inv(c2w)
        name = f"view_{i:03d}"
        images[str(i)] = {"name": name + ".png", "camera_id": "0",
                          "R": w2c[:3, :3].tolist(), "tvec": w2c[:3, 3].tolist()}
        np.save(lseg / f"{name}.npy", rng.random((6, 16, 16)).astype(np.float16))
    cam_json = str(root / "cams.json")
    with open(cam_json, "w") as f:
        json.dump({"images": images, "cameras": {"0": {"params": [20.0, 20.0, 8.0, 8.0]}}}, f)
    return dict(grid_ply=grid_ply, lseg=str(lseg), cam_json=cam_json)


def test_lift_cli_mesh_view_2_matches_one_device(lift_inputs, tmp_path):
    from segsplat_tpu_torch.aggregate_voxel_features_onthefly import main
    from segsplat_tpu_torch.io.artifacts import load_voxel_features

    run_ranks(HERE, "lift", 2, tmp_path, json.dumps(lift_inputs))
    for method in LIFT_METHODS:
        single = tmp_path / f"single_{method}"
        out = main(_lift_argv(lift_inputs, str(single), method))
        assert int(out["counts"].sum()) > 0, "the lift must hit voxels"
        names = sorted(os.listdir(single))
        # 8 views in chunks of 3: a checkpoint at 6 views, then the final files
        assert len(names) == 4 and os.path.basename(out["artifact"]) in names
        sharded = tmp_path / f"lift_{method}_r0"
        assert sorted(os.listdir(sharded)) == names
        assert not (tmp_path / f"lift_{method}_r1").exists()
        for n in names:
            if n.endswith(".ply"):
                assert (sharded / n).read_bytes() == (single / n).read_bytes(), n
                continue
            a, b = load_voxel_features(str(sharded / n)), load_voxel_features(str(single / n))
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{method} {n} {k}")


def test_lift_cli_mesh_view_must_equal_the_world(lift_inputs, tmp_path):
    from segsplat_tpu_torch.aggregate_voxel_features_onthefly import main
    from segsplat_tpu_torch.parallel.mesh import Mesh
    from segsplat_tpu_torch.pipeline.lift_features import aggregate_voxel_features

    for n in ("2", "3"):
        with pytest.raises(ValueError, match=f"--mesh_view {n} must equal the world size 1"):
            main(_lift_argv(lift_inputs, str(tmp_path / "x"), "splat") + ["--mesh_view", n])
    with pytest.raises(ValueError, match="not a tensor axis of 2"):
        aggregate_voxel_features(lift_inputs["grid_ply"], lift_inputs["lseg"],
                                 lift_inputs["cam_json"], str(tmp_path / "y"),
                                 mesh=Mesh(1, 2, 0, 0), device="cpu")


if __name__ == "__main__":
    worker_main(sys.argv[2:], WORKERS)
