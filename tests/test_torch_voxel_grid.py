"""The grid stage of the port (segsplat_tpu_torch/pipeline/voxel_grid.py and the
CLI twin segsplat_tpu_torch/minkowski_voxel_grid_from_ply_advanced.py) against
the JAX package's on one seeded Gaussian PLY: every filter and the quantization
exact (centres, colours, origin, shape, stats), the grid PLYs byte-identical."""

import importlib
import os
import sys

import numpy as np
import pytest

from segsplat_tpu.pipeline import voxel_grid as JG
from segsplat_tpu_torch.io.ply import write_ply
from segsplat_tpu_torch.pipeline import voxel_grid as PG

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


@pytest.fixture(scope="module")
def gaussian_ply(tmp_path_factory):
    """3 000 Gaussians in a unit cube: SH DC colours, logit opacities, log
    scales with a few spiky ones, and normals that mostly agree."""
    rng = np.random.default_rng(0)
    n = 3000
    names = (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2", "opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    v = np.zeros(n, np.dtype([(k, "f4") for k in names]))
    xyz = rng.random((n, 3)) * 2 - 1
    v["x"], v["y"], v["z"] = xyz.T
    normals = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.3, (n, 3))
    v["nx"], v["ny"], v["nz"] = normals.T
    for i in range(3):
        v[f"f_dc_{i}"] = rng.random(n) * 1.2 - 0.1
    v["opacity"] = rng.normal(1.0, 1.0, n)
    scales = np.full((n, 3), -4.0) + rng.normal(0, 0.2, (n, 3))
    scales[::50, 0] = -0.5                       # a ratio past the spikiness cut
    for i in range(3):
        v[f"scale_{i}"] = scales[:, i]
    v["rot_0"] = 1.0
    path = str(tmp_path_factory.mktemp("gply") / "point_cloud.ply")
    write_ply(path, v)
    return path


CONFIGS = {
    "advanced": (dict(cell_size=0.1, density_eps=0.15, density_min_neighbors=3,
                      opacity_threshold=0.5, normal_consistency=0.8,
                      normal_consistency_eps=0.15, normal_consistency_min_neighbors=3),
                 True),
    "adaptive": (dict(cell_size=0.1, density_eps=0.15, density_min_neighbors=3,
                      opacity_threshold=0.5, normal_consistency=1.0, adaptive_density=True),
                 True),
    "basic": (dict(cell_size=0.2), False),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_voxel_grid_matches_jax(gaussian_ply, tmp_path, name):
    kw, advanced = CONFIGS[name]
    got = PG.build_voxel_grid(gaussian_ply, PG.GridFilterConfig(**kw), advanced=advanced)
    ref = JG.build_voxel_grid(gaussian_ply, JG.GridFilterConfig(**kw), advanced=advanced)
    assert got["stats"] == ref["stats"] and got["stats"]["voxels"] > 10
    assert got["shape"] == ref["shape"] and got["voxel_size"] == ref["voxel_size"]
    for k in ("centers", "colors", "origin"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for binary in (False, True):
        PG.save_grid(str(tmp_path / "p.ply"), got, binary=binary)
        JG.save_grid(str(tmp_path / "j.ply"), ref, binary=binary)
        assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_filters_match_jax(gaussian_ply):
    cloud = PG.load_gaussian_cloud(gaussian_ply)
    ref = JG.load_gaussian_cloud(gaussian_ply)
    for k in ref:
        np.testing.assert_array_equal(cloud[k], ref[k], err_msg=k)
    xyz, normals = cloud["xyz"], cloud["normals"]
    np.testing.assert_array_equal(PG.spikiness_mask(cloud["scales_vec"], 10.0),
                                  JG.spikiness_mask(ref["scales_vec"], 10.0))
    np.testing.assert_array_equal(PG.opacity_rank_top(cloud["opacity"], 0.7),
                                  JG.opacity_rank_top(ref["opacity"], 0.7))
    np.testing.assert_array_equal(PG.normal_consistency_mask(xyz, normals, 0.9, 0.1, 4),
                                  JG.normal_consistency_mask(xyz, normals, 0.9, 0.1, 4))
    eps = np.linspace(0.05, 0.2, len(xyz))
    for e in (0.1, eps):
        np.testing.assert_array_equal(PG.density_mask(xyz, e, 4), JG.density_mask(xyz, e, 4))


def test_grid_cli_twin_matches_the_jax_script(gaussian_ply, tmp_path):
    from segsplat_tpu_torch.minkowski_voxel_grid_from_ply_advanced import main

    jax_cli = importlib.import_module("minkowski_voxel_grid_from_ply_advanced")
    flags = ["--ply", gaussian_ply, "--cell_size", "0.1", "--opacity_threshold", "0.5",
             "--density_eps", "0.15", "--density_min_neighbors", "3",
             "--normal_consistency", "0.8", "--normal_consistency_eps", "0.15",
             "--normal_consistency_min_neighbors", "3"]
    out = main(flags + ["--output_dir", str(tmp_path / "port")])
    jax_cli.main(flags + ["--output_dir", str(tmp_path / "jax")])
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == \
        [os.path.basename(out)]
    with open(out, "rb") as a, open(tmp_path / "jax" / os.path.basename(out), "rb") as b:
        assert a.read() == b.read()
