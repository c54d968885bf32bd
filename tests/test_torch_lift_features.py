"""The multi-view lift of the port (segsplat_tpu_torch/pipeline/lift_features.py
and its CLI twin segsplat_tpu_torch/aggregate_voxel_features_onthefly.py)
against the JAX package's on one seeded scene, on the CPU: both methods, both
camera-JSON layouts, five views with a checkpoint at 3; in chunks of two for
the splat (so the JAX run pads its tail chunk and the port's does not), of one
for the DDA, whose padded views the JAX package lifts wrongly. Counts exact, the
artifacts' avg_feats equal in fp16 (the features are multiples of 1/64 and the
×2 upsample's weights are 0.75/0.25, so every float sum is exact in both
packages), checkpoint names, hit-count PLYs and provenance as JAX writes them;
the resize against ``jax.image.resize`` at 1e-5, down and up."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy, occupied_voxels
from segsplat_tpu.pipeline import lift_features as JF
from segsplat_tpu_torch.io.artifacts import load_voxel_features
from segsplat_tpu_torch.io.ply import write_voxel_grid_ply
from segsplat_tpu_torch.pipeline import lift_features as PF

W, H, C, N_VIEWS = 48, 40, 16, 5


@pytest.fixture(scope="module")
def lift_scene(tmp_path_factory):
    """The grid of tests/test_lift_splat.py as a voxel PLY, five views around it
    in both JSON layouts, and fp16 feature maps: at half the ray grid for the
    {"images", "cameras"} layout (whose cameras carry their size), at the ray
    grid for the flat one (whose do not)."""
    root = tmp_path_factory.mktemp("lift")
    rng = np.random.default_rng(0)
    centers, _ = occupied_voxels(lift_occupancy(rng), LIFT_VS, LIFT_ORIGIN)
    ply = str(root / "grid.ply")
    write_voxel_grid_ply(ply, centers, np.full((len(centers), 3), 127, np.uint8), LIFT_VS,
                         LIFT_ORIGIN, grid_shape=(12, 8, 10))
    images, flat = {}, []
    for i in range(N_VIEWS):
        c2w = lift_camera(i, N_VIEWS).astype(np.float64)
        R = c2w[:3, :3].T
        entry = {"R": R.tolist(), "tvec": (-R @ c2w[:3, 3]).tolist()}
        images[str(i)] = dict(entry, name=f"view{i:03d}.jpg", camera_id="0")
        flat.append(dict(entry, name=f"view{i:03d}.jpg", intrinsic=[90.0, 90.0, 48.0, 40.0]))
    out = {"root": str(root), "ply": ply}
    for layout, data, (h, w) in (
            ("images", {"images": images, "cameras": {"0": {
                "params": [90.0, 90.0, 48.0, 40.0], "width": 2 * W, "height": 2 * H}}},
             (H // 2, W // 2)),
            ("flat", {"cameras": flat}, (H, W))):
        fdir = root / f"feats_{layout}"
        fdir.mkdir()
        for i in range(N_VIEWS):
            q = rng.integers(0, 65, (C, h, w)) / 64.0
            np.save(fdir / f"view{i:03d}.npy", q.astype(np.float16))
        cam = str(root / f"cameras_{layout}.json")
        with open(cam, "w") as f:
            json.dump(data, f)
        out[layout] = (str(fdir), cam)
    return out


def _cfg(mod, method, view_chunk=None):
    """Chunks of two views for the splat; of one for the DDA, whose padded
    tail view the JAX package lifts wrongly (see the test after the next)."""
    if view_chunk is None:
        view_chunk = 2 if method == "splat" else 1
    return mod.LiftConfig(method=method, view_chunk=view_chunk, checkpoint_every=3)


@pytest.mark.parametrize("method", ["splat", "dda"])
@pytest.mark.parametrize("layout", ["images", "flat"])
def test_aggregate_matches_jax(lift_scene, tmp_path, layout, method):
    feats, cams = lift_scene[layout]
    got = PF.aggregate_voxel_features(lift_scene["ply"], feats, cams, str(tmp_path / "port"),
                                      _cfg(PF, method), device="cpu")
    ref = JF.aggregate_voxel_features(lift_scene["ply"], feats, cams, str(tmp_path / "jax"),
                                      _cfg(JF, method))
    counts = got["counts"].numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref["counts"]))
    assert (counts[1:] > 0).sum() > 20 and got["overflow"] == 0
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(ref["sums"]), rtol=1e-5,
                               atol=1e-5)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    # one checkpoint, where the views done first reach 3, and the final
    # artifact, each a .pt and a hit-count .ply
    first = "checkpoint_4img_" if method == "splat" else "checkpoint_3img_"
    assert len(names) == 4 and sum(n.startswith(first) for n in names) == 2
    for n in names:
        a, b = str(tmp_path / "port" / n), str(tmp_path / "jax" / n)
        if n.endswith(".ply"):
            assert open(a, "rb").read() == open(b, "rb").read(), n
        else:
            pa, pj = load_voxel_features(a), load_voxel_features(b)
            assert sorted(pa) == sorted(pj)
            for k in pj:
                assert pa[k].dtype == pj[k].dtype
                np.testing.assert_array_equal(pa[k], pj[k], err_msg=f"{n}:{k}")
    raw = torch.load(got["artifact"], weights_only=True)
    assert raw["avg_feats"].dtype == torch.float16
    # the same bits on a second run
    again = PF.aggregate_voxel_features(lift_scene["ply"], feats, cams, str(tmp_path / "p2"),
                                        _cfg(PF, method), device="cpu")
    assert torch.equal(again["sums"], got["sums"]) and torch.equal(again["counts"],
                                                                   got["counts"])


def test_dda_tail_chunk_unpadded_where_the_jax_padding_hits(lift_scene, tmp_path):
    """The JAX package pads a short tail chunk with views of zero c2w and
    intrinsics (1, 1, -1e9, 0). Its DDA turns their rays into NaN directions,
    NaN rounds to voxel (0, 0, 0), and where that voxel is occupied (id 1 here,
    the back wall) each padded view adds H·W hits of zero features to it. The
    port does not pad: with chunks of two it equals the JAX run in chunks of
    one, and the padded JAX run differs from it at id 1 alone, by H·W."""
    feats, cams = lift_scene["images"]
    got = PF.aggregate_voxel_features(lift_scene["ply"], feats, cams, str(tmp_path / "p"),
                                      _cfg(PF, "dda", 2), device="cpu")
    ref = JF.aggregate_voxel_features(lift_scene["ply"], feats, cams, str(tmp_path / "j"),
                                      _cfg(JF, "dda", 1))
    padded = JF.aggregate_voxel_features(lift_scene["ply"], feats, cams, str(tmp_path / "jp"),
                                         _cfg(JF, "dda", 2))
    counts = got["counts"].numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref["counts"]))
    np.testing.assert_array_equal(got["sums"].numpy(), np.asarray(ref["sums"]))
    diff = np.asarray(padded["counts"]) - counts
    assert diff[1] == H * W and not diff[2:].any() and not diff[0]


@pytest.mark.parametrize("src,dst", [((15, 22), (30, 44)), ((30, 44), (13, 17)),
                                     ((31, 17), (9, 50)), ((20, 30), (20, 30))])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(1).random((6,) + src).astype(np.float16)
    ref = np.asarray(jax.image.resize(jnp.asarray(x).astype(jnp.float32), (6,) + dst,
                                      method="bilinear"))
    got = PF.resize_features(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_camera_json_layouts_parse_as_jax(lift_scene):
    for layout in ("images", "flat"):
        feats, cams = lift_scene[layout]
        got, ref = PF.load_camera_json(cams), JF.load_camera_json(cams)
        assert got == ref
        files = sorted(os.path.join(feats, f) for f in os.listdir(feats)) + ["nocam.npy"]
        g = PF.camera_arrays_for(files, *got[:2], 0.5)
        r = JF.camera_arrays_for(files, *ref[:2], 0.5)
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])
        assert g[2] == r[2] and len(g[2]) == N_VIEWS


def test_provenance_taint_as_jax(lift_scene, tmp_path):
    from segsplat_tpu_torch.io.provenance import PROVENANCE_FILE, write_provenance

    feats, cams = lift_scene["images"]
    tainted = tmp_path / "tainted"
    tainted.mkdir()
    for f in os.listdir(feats):
        (tainted / f).write_bytes(open(os.path.join(feats, f), "rb").read())
    write_provenance(str(tainted), "random", stage="lseg")
    with pytest.raises(RuntimeError, match="RANDOM weights"):
        PF.aggregate_voxel_features(lift_scene["ply"], str(tainted), cams,
                                    str(tmp_path / "refused"), device="cpu")
    kw = dict(first_only=True, allow_random_weights=True)
    PF.aggregate_voxel_features(lift_scene["ply"], str(tainted), cams, str(tmp_path / "p"),
                                device="cpu", **kw)
    JF.aggregate_voxel_features(lift_scene["ply"], str(tainted), cams, str(tmp_path / "j"),
                                **kw)
    for d in "pj":
        with open(tmp_path / d / PROVENANCE_FILE) as f:
            assert json.load(f) == {"weights_source": "random", "stage": "lift"}


def test_cli_twin_matches_the_jax_cli(lift_scene, tmp_path, capsys):
    import aggregate_voxel_features_onthefly as jax_cli

    from segsplat_tpu_torch.aggregate_voxel_features_onthefly import main

    feats, cams = lift_scene["images"]
    flags = ["--voxel_ply", lift_scene["ply"], "--lseg_dir", feats, "--camera_params", cams,
             "--max_views", "3", "--view_chunk", "2"]
    out = main(flags + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_cli.main(flags + ["--out_dir", str(tmp_path / "jax"), "--mesh_view", "1"])
    assert "[DONE]" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 2
    assert os.path.basename(out["artifact"]) in names
    for n in names:
        if n.endswith(".ply"):
            assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
        else:
            a = load_voxel_features(str(tmp_path / "port" / n))
            b = load_voxel_features(str(tmp_path / "jax" / n))
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a mesh larger than the launch's world (1 here) is refused, naming both
    with pytest.raises(ValueError, match="--mesh_view 2 must equal the world size 1"):
        main(flags + ["--out_dir", str(tmp_path / "x"), "--mesh_view", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(flags + ["--out_dir", str(tmp_path / "x")])
