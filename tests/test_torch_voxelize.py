"""The lift substrate of the port against the JAX package on the same seeded
inputs: ``ops/voxelize`` (exact: keys, ids, counts, occupancy; sums at 1e-5),
``core/types.VoxelGrid``, the voxel-grid PLY dialect of ``io/ply`` (files
byte-identical) and the voxel-feature artifacts of ``io/artifacts`` (written by
either package, read by the other: same keys, dtypes and values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.core.types import VoxelGrid as JaxVoxelGrid
from segsplat_tpu.io import artifacts as JA
from segsplat_tpu.io import ply as JP
from segsplat_tpu.ops import voxelize as JV
from segsplat_tpu_torch.core.types import VoxelGrid
from segsplat_tpu_torch.io import artifacts as PA
from segsplat_tpu_torch.io import ply as PP
from segsplat_tpu_torch.ops import voxelize as PV


def _t(x):
    return torch.from_numpy(np.array(x))


def test_voxelize_points_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 2
    feats = rng.random((500, 4)).astype(np.float32)
    for reduction in ("mean", "sum"):
        ref = JV.voxelize_points(pts, 0.25, features=feats, reduction=reduction)
        got = PV.voxelize_points(pts, 0.25, features=feats, reduction=reduction,
                                 device="cpu")
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
        np.testing.assert_array_equal(got.origin.numpy(), np.asarray(ref.origin))
        np.testing.assert_array_equal(got.features.numpy(), np.asarray(ref.features))
        assert got.shape == ref.shape and got.coords.dtype == torch.int32
        np.testing.assert_array_equal(got.centers().numpy(), np.asarray(ref.centers()))


@pytest.mark.parametrize("shift", [0.0, -0.7])
def test_occupancy_from_grid_matches_jax(shift):
    """round() snap, 1-based ids in input order; a shifted origin makes some
    indices negative, so the origin moves as the reference's does."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    ref_grid = JV.voxelize_points(pts, 0.3)
    origin = np.asarray(ref_grid.origin) + np.float32(shift)
    jg = JaxVoxelGrid(coords=ref_grid.coords, origin=jnp.asarray(origin),
                      voxel_size=ref_grid.voxel_size, shape=ref_grid.shape)
    pg = VoxelGrid(coords=_t(ref_grid.coords), origin=_t(origin),
                   voxel_size=torch.tensor(0.3), shape=ref_grid.shape)
    for round_centers in (True, False):
        occ, o, shape = PV.occupancy_from_grid(pg, round_centers)
        rocc, ro, rshape = JV.occupancy_from_grid(jg, round_centers)
        assert shape == rshape and occ.dtype == torch.int32
        np.testing.assert_array_equal(occ.numpy(), np.asarray(rocc))
        np.testing.assert_array_equal(o, ro)


def test_reduce_and_count_by_voxel_match_jax():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(400, 4)).astype(np.float32)
    ivals = rng.integers(-50, 50, (400, 4)).astype(np.int32)
    ids = rng.integers(-1, 12, 400).astype(np.int32)
    for v in (vals, ivals):
        for red in ("sum", "max"):
            got = PV.reduce_by_voxel(_t(v), _t(ids), 14, red).numpy()
            ref = np.asarray(JV.reduce_by_voxel(jnp.asarray(v), jnp.asarray(ids), 14, red))
            assert got.dtype == ref.dtype
            if red == "sum" and v.dtype == np.float32:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(PV.count_by_voxel(_t(ids), 14).numpy(),
                                  np.asarray(JV.count_by_voxel(jnp.asarray(ids), 14)))


def test_pack_unpack_and_unique_match_jax():
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 50, (64, 3)).astype(np.int32)
    keys = PV.pack_coords(_t(coords), (50, 60))
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(JV.pack_coords(jnp.asarray(coords), (50, 60))))
    np.testing.assert_array_equal(PV.unpack_key(keys, (50, 60)).numpy(), coords)
    with pytest.raises(ValueError, match="2\\^31"):
        PV.pack_coords(_t(coords), (2048, 1024, 1024))
    small = rng.integers(0, 4, (100, 3)).astype(np.int32)
    for capacity in (100, 20):        # 20 < the 40-odd uniques: the rest are dropped
        got = PV.unique_voxels_jit(_t(small), capacity, (4, 4))
        ref = JV.unique_voxels_jit(jnp.asarray(small), capacity, (4, 4))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_segment_sum_is_deterministic():
    rng = np.random.default_rng(4)
    vals = _t(rng.normal(size=(5000, 16)).astype(np.float32))
    ids = _t(rng.integers(0, 30, 5000))
    a, b = PV.segment_sum(vals, ids, 30), PV.segment_sum(vals, ids, 30)
    assert torch.equal(a, b)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("shape", [None, (7, 5, 3)])
def test_voxel_grid_ply_is_byte_identical_and_reads_back(tmp_path, binary, shape):
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(40, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    origin = np.array([-1.25, 0.5, 2.0], np.float32)
    PP.write_voxel_grid_ply(str(tmp_path / "p.ply"), centers, colors, 0.04, origin,
                            grid_shape=shape, binary=binary)
    JP.write_voxel_grid_ply(str(tmp_path / "j.ply"), centers, colors, 0.04, origin,
                            grid_shape=shape, binary=binary)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got = PP.read_voxel_grid_ply(str(tmp_path / "j.ply"))
    ref = JP.read_voxel_grid_ply(str(tmp_path / "j.ply"))
    for g, r in zip(got, ref):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r)
            assert g.dtype == r.dtype
        else:
            assert g == r
    c = PP.read_ply(str(tmp_path / "j.ply"))
    assert (c.voxel_size, c.grid_shape) == (0.04, shape)
    np.testing.assert_array_equal(c.grid_origin, origin)


def test_gaussian_ply_has_no_grid_fields(tmp_path):
    """A Gaussian checkpoint PLY carries no grid comments: the fields are None."""
    n = 5
    PP.save_gaussian_ply(str(tmp_path / "g.ply"), np.zeros((n, 3)), np.zeros((n, 1, 3)),
                         np.zeros((n, 15, 3)), np.zeros((n, 1)), np.zeros((n, 3)),
                         np.ones((n, 4)))
    c = PP.read_ply(str(tmp_path / "g.ply"))
    assert c.voxel_size is None and c.grid_origin is None and c.grid_shape is None
    comments = ["voxel_size 0.5", "grid_origin 1 2.5 3", "grid_shape 2 3 4.0", "other"]
    got, ref = PP._parse_grid_comments(comments), JP._parse_grid_comments(comments)
    assert got[0] == ref[0] == 0.5 and got[2] == ref[2] == (2, 3, 4)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype


@pytest.mark.parametrize("suffix", [".pt", ".npz"])
def test_voxel_feature_artifacts_cross_read(tmp_path, suffix):
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(30, 3)).astype(np.float32)
    feats = rng.normal(size=(30, 8)).astype(np.float32)
    coords = rng.integers(0, 40, (30, 3))
    PA.save_voxel_features(str(tmp_path / f"p{suffix}"), xyz, feats, coords)
    JA.save_voxel_features(str(tmp_path / f"j{suffix}"), xyz, feats, coords)
    for writer in "pj":
        path = str(tmp_path / f"{writer}{suffix}")
        got, ref = PA.load_voxel_features(path), JA.load_voxel_features(path)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k])
    if suffix == ".pt":
        raw = torch.load(str(tmp_path / "p.pt"), weights_only=True)
        assert {k: v.dtype for k, v in raw.items()} == {
            "xyz": torch.float32, "avg_feats": torch.float16, "voxel_coords": torch.int64}


def test_feature_map_round_trip(tmp_path):
    fmap = np.random.default_rng(7).random((6, 5, 4)).astype(np.float32)
    PA.save_feature_map(str(tmp_path / "a.npy"), fmap)
    JA.save_feature_map(str(tmp_path / "b.npy"), fmap)
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()
    got = PA.load_feature_map(str(tmp_path / "b.npy"))
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, JA.load_feature_map(str(tmp_path / "a.npy")))
