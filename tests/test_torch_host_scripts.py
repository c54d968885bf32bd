"""The port's twins of the host scripts (segsplat_tpu_torch/<name>.py) against
the JAX package's scripts (scripts/<name>.py), on the CPU: each pair runs its
``main(argv)`` on the same seeded tiny inputs, the port's with ``--device
cpu`` where it takes one; their output files are compared byte for byte or
array by array (each case states its tolerance) and their printed summaries
line for line, with the output paths replaced. Also: the device twins raise
without a card unless given ``--device cpu``, and ``check_env``'s exit codes."""

import contextlib
import importlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from segsplat_tpu.core.types import GaussianTable as JaxGaussianTable  # noqa: E402
from segsplat_tpu.scene import save_gaussian_table as jax_save_gaussian_table  # noqa: E402
from segsplat_tpu_torch import check_env  # noqa: E402
from segsplat_tpu_torch.io.artifacts import save_semantics, save_voxel_features  # noqa: E402
from segsplat_tpu_torch.io.ply import (read_ply, read_voxel_grid_ply,  # noqa: E402
                                       save_gaussian_ply, write_voxel_grid_ply)
from _torch_port import (LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy,  # noqa: E402
                         occupied_voxels, query_scene, torch_threads, write_blender_scene)

SCRIPTS = ("prepare_tensor_data", "project_features", "build_sparse_occupancy",
           "aggregate_voxel_colors_onthefly", "voxeltovoxel_logits",
           "extract_gaussian_centers", "logit_confidence_map", "analyze_gaussian_semantics",
           "minkowski_voxel_grid", "minkowski_voxel_grid_from_ply",
           "minkowski_voxel_grid_density_filtered", "minkowski_mesh_voxel_grid",
           "detect_surface", "export_gaussians", "export_gaussian_ellipsoids",
           "gaussian_color_stats", "scale_sparsity_filter", "dist_to_mesh_filter",
           "debug_tools", "visualize_lseg_features")
DEVICE_SCRIPTS = ("prepare_tensor_data", "project_features", "build_sparse_occupancy",
                  "aggregate_voxel_colors_onthefly", "voxeltovoxel_logits")
W, H, C, VIEWS = 48, 40, 16, 3       # ray grid, feature channels, views
PROMPTS = ["wall", "chair", "floor"]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    with torch_threads(2):
        yield


def _scripts(name):
    """(the JAX script's module, the port twin's module)."""
    return (importlib.import_module(name),
            importlib.import_module(f"segsplat_tpu_torch.{name}"))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _both(name, argv_for, tmp_path, device=False):
    """Run the JAX script and the twin with ``argv_for(out_dir)``, each into its
    own directory (the twin with ``--device cpu`` when ``device``). Returns
    ({"jax", "port"} → output dir, {"jax", "port"} → stdout with the output
    dir written as OUT)."""
    dirs, outs = {}, {}
    for side, mod in zip(("jax", "port"), _scripts(name)):
        d = tmp_path / side
        d.mkdir(parents=True)
        argv = argv_for(str(d)) + (["--device", "cpu"] if device and side == "port" else [])
        dirs[side] = d
        outs[side] = _run(mod.main, argv).replace(str(d), "OUT")
    return dirs, outs


def _same_files(dirs, *names):
    for n in names:
        assert (dirs["port"] / n).read_bytes() == (dirs["jax"] / n).read_bytes(), n


def _write_mesh(path, verts, faces):
    """A binary PLY with float xyz vertices and uchar-int triangle lists."""
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
                 "end_header\n").encode("ascii"))
        f.write(np.asarray(verts, "<f4").tobytes())
        fa = np.zeros(len(faces), [("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
        fa["n"], fa["a"], fa["b"], fa["c"] = 3, faces[:, 0], faces[:, 1], faces[:, 2]
        f.write(fa.tobytes())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded tiny inputs: a 200-Gaussian PLY and a resumable checkpoint of it;
    tests/test_lift_splat.py's grid as a voxel PLY, its occupancy, three views
    around it (camera JSON, noise images at the 48×40 ray grid, 16-channel
    feature maps at half of it) and a tensor_data .pt of them; a voxel
    feature table, a semantics .npz, [P, H, W] logits, a mesh and a Blender
    scene."""
    root = tmp_path_factory.mktemp("host_scripts")
    rng = np.random.default_rng(0)
    n = 200
    g = dict(xyz=rng.normal(size=(n, 3)) * 0.6, features_dc=rng.normal(size=(n, 1, 3)),
             features_rest=rng.normal(size=(n, 15, 3)) * 0.1,
             opacity=rng.normal(0.5, 1.5, (n, 1)), scaling=rng.normal(-3, 0.3, (n, 3)),
             rotation=rng.normal(size=(n, 4)), objects_dc=rng.normal(size=(n, 1, 16)))
    g = {k: v.astype(np.float32) for k, v in g.items()}
    gauss = str(root / "point_cloud.ply")
    save_gaussian_ply(gauss, **g)
    active = np.ones(n + 56, bool)
    active[n:] = False
    padded = {k: np.concatenate([v, np.zeros((56,) + v.shape[1:], np.float32)])
              for k, v in g.items()}
    ckpt = str(root / "chkpnt7.pt")
    torch.save({"table": {k: torch.from_numpy(v) for k, v in padded.items()},
                "active": torch.from_numpy(active), "active_sh_degree": 2, "step": 7}, ckpt)

    occ = lift_occupancy(rng)
    centers, _ = occupied_voxels(occ, LIFT_VS, LIFT_ORIGIN)
    grid = str(root / "grid.ply")
    write_voxel_grid_ply(grid, centers, rng.integers(0, 256, (len(centers), 3), np.uint8),
                         LIFT_VS, LIFT_ORIGIN, grid_shape=(12, 8, 10))
    occ_pt = str(root / "occupancy.pt")
    torch.save({"occupancy_3D": torch.from_numpy(occ),
                "grid_origin": torch.from_numpy(LIFT_ORIGIN), "voxel_size": LIFT_VS}, occ_pt)
    images, c2ws = {}, []
    feats, imgs = root / "feats", root / "images"
    feats.mkdir()
    imgs.mkdir()
    for i in range(VIEWS):
        c2w = lift_camera(i, VIEWS).astype(np.float64)
        c2ws.append(c2w)
        R = c2w[:3, :3].T
        images[str(i)] = {"name": f"view{i:03d}.jpg", "camera_id": "0", "R": R.tolist(),
                          "tvec": (-R @ c2w[:3, 3]).tolist()}
        np.save(feats / f"view{i:03d}.npy",
                (rng.integers(0, 65, (C, H // 2, W // 2)) / 64.0).astype(np.float16))
        Image.fromarray(rng.integers(0, 256, (H, W, 3), np.uint8)).save(imgs / f"view{i:03d}.png")
    cams = str(root / "cameras.json")
    with open(cams, "w") as f:
        json.dump({"images": images, "cameras": {"0": {
            "params": [90.0, 90.0, 48.0, 40.0], "width": 2 * W, "height": 2 * H}}}, f)
    tensor_data = str(root / "tensor_data.pt")
    intr = np.tile(np.array([45.0, 45.0, 24.0, 20.0], np.float32), (VIEWS, 1))
    torch.save({"encoded_2d_features": torch.from_numpy(
                    rng.random((1, VIEWS, H, W, C)).astype(np.float32)),
                "occupancy_3D": torch.from_numpy(occ),
                "intrinsicParams": torch.from_numpy(intr[None]),
                "viewMatrixInv": torch.from_numpy(np.stack(c2ws).astype(np.float32)[None]),
                "grid_origin": torch.from_numpy(LIFT_ORIGIN), "voxel_size": LIFT_VS},
               tensor_data)

    sc = query_scene()
    vox = str(root / "vox" / "ALL_nonzero_voxel_features_300vox.pt")
    save_voxel_features(vox, sc["pos"], sc["feat"], sc["coords"])
    logits = rng.normal(size=(n, len(PROMPTS))).astype(np.float32)
    semantics = str(root / "gaussian_semantics.npz")
    save_semantics(semantics, labels=logits.argmax(1), logits=logits, prompts=PROMPTS)
    view_logits = str(root / "view_logits.npy")
    np.save(view_logits, rng.normal(size=(len(PROMPTS), 24, 32)).astype(np.float32) * 3)

    mesh = str(root / "mesh.ply")
    box = np.array([[x, y, z] for x in (-1, 1) for y in (-0.5, 0.5) for z in (-0.8, 0.8)],
                   np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    _write_mesh(mesh, box, faces)
    (root / "scene").mkdir()
    scene = write_blender_scene(root / "scene")
    return dict(root=root, gauss=gauss, ckpt=ckpt, table=padded, active=active, grid=grid,
                occ=occ_pt, feats=str(feats), images=str(imgs), cams=cams,
                tensor_data=tensor_data, vox=vox, semantics=semantics,
                view_logits=view_logits, mesh=mesh, scene=scene)


# ───────────────────────────── a. single-view lift ─────────────────────────────

def case_prepare_tensor_data(inp, tmp_path):
    dirs, outs = _both("prepare_tensor_data", lambda d: [
        "--lseg_dir", inp["feats"], "--scaled_camera_params", inp["cams"],
        "--occupancy", inp["occ"], "--voxel_size", str(LIFT_VS),
        "--grid_origin", *map(str, LIFT_ORIGIN), "--max_images", "2",
        "--output", os.path.join(d, "td.pt"), "--image_size", str(H), str(W),
        "--downsample_factor", "0.5"], tmp_path, device=True)
    assert outs["port"] == outs["jax"] == "[DONE] 2 view(s) → OUT/td.pt\n"
    got, ref = (torch.load(dirs[s] / "td.pt", weights_only=False) for s in ("port", "jax"))
    assert got.keys() == ref.keys() and got["voxel_size"] == ref["voxel_size"]
    # the resize: F.interpolate(antialias) against jax.image.resize, 1e-5
    np.testing.assert_allclose(got["encoded_2d_features"].numpy(),
                               ref["encoded_2d_features"].numpy(), atol=1e-5)
    assert got["encoded_2d_features"].shape == (1, 2, H, W, C)
    for k in ("occupancy_3D", "intrinsicParams", "viewMatrixInv", "grid_origin"):
        assert torch.equal(got[k], ref[k]), k


def _project(method):
    def case(inp, tmp_path):
        dirs, outs = _both("project_features", lambda d: [
            "--tensor_data", inp["tensor_data"], "--output", os.path.join(d, "proj.pt"),
            "--method", method], tmp_path, device=True)
        assert outs["port"] == outs["jax"] and "voxels hit" in outs["jax"]
        got, ref = (torch.load(dirs[s] / "proj.pt") for s in ("port", "jax"))
        assert torch.equal(got["projected_indices"], ref["projected_indices"])
        assert len(ref["projected_indices"]) > 10
        # fp16 means of sums that agree to 1e-5: within one fp16 spacing
        a, b = got["projected_feats"].numpy(), ref["projected_feats"].numpy()
        assert a.dtype == b.dtype == np.float16
        spacing = np.spacing(np.abs(b)).astype(np.float32)
        assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= spacing).all()
    return case


def case_build_sparse_occupancy(inp, tmp_path):
    dirs, outs = _both("build_sparse_occupancy", lambda d: [
        "--voxel_ply", inp["grid"], "--output", os.path.join(d, "occ.pt")], tmp_path,
        device=True)
    assert outs["port"] == outs["jax"] and "occupied" in outs["jax"]
    got, ref = (torch.load(dirs[s] / "occ.pt") for s in ("port", "jax"))
    assert got.keys() == ref.keys() and got["voxel_size"] == ref["voxel_size"]
    assert torch.equal(got["occupancy_3D"], ref["occupancy_3D"])
    assert torch.equal(got["grid_origin"], ref["grid_origin"])


def case_aggregate_voxel_colors_onthefly(inp, tmp_path):
    dirs, outs = _both("aggregate_voxel_colors_onthefly", lambda d: [
        "--voxel_ply", inp["grid"], "--images_dir", inp["images"],
        "--camera_params", inp["cams"], "--out_dir", d, "--max_views", str(VIEWS)],
        tmp_path, device=True)
    done = [[line for line in outs[s].splitlines() if line.startswith("[DONE]")]
            for s in ("port", "jax")]
    assert done[0] == done[1] and len(done[0]) == 1
    name = done[0][0].split("OUT/")[1]
    got, ref = (read_voxel_grid_ply(str(dirs[s] / name)) for s in ("port", "jax"))
    np.testing.assert_array_equal(got[0], ref[0])           # centres
    assert len(ref[0]) > 10                                 # voxels some view hit
    assert got[2] == ref[2] and got[4] == ref[4]           # voxel size, grid shape
    np.testing.assert_array_equal(got[3], ref[3])           # origin
    # mean colours from sums that agree to 1e-5, truncated to 8 bits: ±1
    assert np.abs(got[1].astype(int) - ref[1].astype(int)).max() <= 1


# ───────────────────────────── b. query and logits ─────────────────────────────

def case_voxeltovoxel_logits(inp, tmp_path):
    dirs, outs = _both("voxeltovoxel_logits", lambda d: [
        "--vox", inp["vox"], "--prompt", *PROMPTS, "--out", os.path.join(d, "sem.npz")],
        tmp_path, device=True)
    got, ref = (np.load(dirs[s] / "sem.npz") for s in ("port", "jax"))
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-5, atol=1e-5 * scale)
    top2 = np.sort(ref["logits"], axis=1)
    clear = top2[:, -1] - top2[:, -2] > 1e-3 * scale      # labels beyond a near-tie
    np.testing.assert_array_equal(got["labels"][clear], ref["labels"][clear])
    assert clear.mean() > 0.9 and list(got["prompts"]) == list(ref["prompts"])
    if (got["labels"] == ref["labels"]).all():
        # the histogram line (the packages word their hash-embedding warning
        # differently)
        hist = [[ln for ln in outs[s].splitlines() if ln.startswith("[INFO]")]
                for s in ("port", "jax")]
        assert hist[0] == hist[1] and len(hist[0]) == 1
        _same_files(dirs, "sem_voxels.ply")


def case_extract_gaussian_centers(inp, tmp_path):
    dirs, outs = _both("extract_gaussian_centers", lambda d: [
        "--ply", inp["gauss"], "--out", os.path.join(d, "mu.npy")], tmp_path)
    assert outs["port"] == outs["jax"] == "[DONE] 200 centers → OUT/mu.npy\n"
    _same_files(dirs, "mu.npy")


def case_logit_confidence_map(inp, tmp_path):
    dirs, outs = _both("logit_confidence_map", lambda d: [
        "--logits", inp["view_logits"], "--out", os.path.join(d, "conf.png")], tmp_path)
    assert outs["port"] == outs["jax"] and "mean" in outs["jax"]
    for name in ("conf.png", "conf_colorbar.png"):
        a, b = (np.asarray(Image.open(dirs[s] / name)) for s in ("port", "jax"))
        np.testing.assert_array_equal(a, b)


def case_analyze_gaussian_semantics(inp, tmp_path):
    _, outs = _both("analyze_gaussian_semantics", lambda d: [
        "--semantics", inp["semantics"]], tmp_path)
    assert outs["port"] == outs["jax"] and "confidence margin" in outs["jax"]


# ───────────────────────────── c. grid builders ─────────────────────────────

def _grid_case(name, *flags):
    def case(inp, tmp_path):
        src = inp["mesh"] if name == "minkowski_mesh_voxel_grid" else inp["gauss"]
        dirs, outs = _both(name, lambda d: [
            "--mesh" if name == "minkowski_mesh_voxel_grid" else "--ply", src,
            "--output_dir", d, *flags], tmp_path)
        assert outs["port"] == outs["jax"] and "[DONE]" in outs["jax"]
        files = sorted(os.listdir(dirs["jax"]))
        assert files == sorted(os.listdir(dirs["port"])) and len(files) == 1
        _same_files(dirs, *files)
        assert len(read_ply(str(dirs["jax"] / files[0])).vertex) > 5
    return case


def case_detect_surface(inp, tmp_path):
    dirs, outs = _both("detect_surface", lambda d: [
        "--ply", inp["gauss"], "--out", os.path.join(d, "surface.ply"),
        "--opacity_threshold", "0.3", "--max_scale", "1.0", "--density_k", "8",
        "--dbscan_eps", "0.6", "--dbscan_min_samples", "3"], tmp_path)
    assert outs["port"] == outs["jax"] and "surface points" in outs["jax"]
    _same_files(dirs, "surface.ply")


# ───────────────────────────── d. Gaussian PLY tools ─────────────────────────────

def case_export_gaussians(inp, tmp_path):
    for cmd in ("stats", "count"):
        _, outs = _both("export_gaussians", lambda d: [cmd, "--ply", inp["gauss"]],
                        tmp_path / cmd)
        assert outs["port"] == outs["jax"] and outs["jax"]
    # from_checkpoint reads the port's torch.save checkpoint; the JAX script
    # reads an orbax directory. The PLY is held against the JAX package's
    # save_gaussian_table of the same table.
    _, port = _scripts("export_gaussians")
    out = tmp_path / "from_ckpt.ply"
    assert _run(port.main, ["from_checkpoint", "--checkpoint", inp["ckpt"], "--out",
                            str(out)]).startswith("[DONE]")
    ref = tmp_path / "jax_table.ply"
    jax_save_gaussian_table(str(ref), JaxGaussianTable(
        **inp["table"], active=inp["active"], active_sh_degree=2, max_sh_degree=3))
    assert out.read_bytes() == ref.read_bytes()


def case_export_gaussian_ellipsoids(inp, tmp_path):
    dirs, outs = _both("export_gaussian_ellipsoids", lambda d: [
        "--ply", inp["gauss"], "--out", os.path.join(d, "ell.ply"), "--max_gaussians", "50",
        "--scale_mult", "2.0"], tmp_path)
    assert outs["port"] == outs["jax"] == "[DONE] 50 ellipsoids (600 verts) → OUT/ell.ply\n"
    _same_files(dirs, "ell.ply")


def case_gaussian_color_stats(inp, tmp_path):
    for mode, src in (("dc", inp["gauss"]), ("rgb", inp["grid"])):
        sub = tmp_path / mode
        sub.mkdir()
        dirs, outs = {}, {}
        for side, mod in zip(("jax", "port"), _scripts("gaussian_color_stats")):
            d = sub / side
            d.mkdir()
            ply = shutil.copy(src, d / "in.ply")      # dc mode writes PNGs beside it
            dirs[side] = d
            outs[side] = _run(mod.main, ["--ply", str(ply), "--mode", mode, "--bins", "8"]
                              ).replace(str(d), "OUT")
        assert outs["port"] == outs["jax"] and "histogram" in outs["jax"]
        pngs = sorted(p for p in os.listdir(dirs["jax"]) if p.endswith(".png"))
        assert pngs == sorted(p for p in os.listdir(dirs["port"]) if p.endswith(".png"))
        assert len(pngs) == (3 if mode == "dc" else 0)


def case_scale_sparsity_filter(inp, tmp_path):
    dirs, outs = _both("scale_sparsity_filter", lambda d: [
        "--ply", inp["gauss"], "--out", os.path.join(d, "kept.ply"), "--min_scale", "-3.2",
        "--max_scale", "-2.8"], tmp_path)
    assert outs["port"] == outs["jax"] and "kept" in outs["jax"]
    _same_files(dirs, "kept.ply")
    assert 0 < len(read_ply(str(dirs["jax"] / "kept.ply")).vertex) < 200


def case_dist_to_mesh_filter(inp, tmp_path):
    dirs, outs = _both("dist_to_mesh_filter", lambda d: [
        "--ply", inp["gauss"], "--ref_ply", inp["grid"], "--out", os.path.join(d, "kept.ply"),
        "--max_dist", "0.3"], tmp_path)
    assert outs["port"] == outs["jax"]
    _same_files(dirs, "kept.ply")
    assert 0 < len(read_ply(str(dirs["jax"] / "kept.ply")).vertex) < 200


# ───────────────────────────── e. debug and visual tools ─────────────────────────────

def case_debug_tools(inp, tmp_path):
    runs = [["ply_fields", inp["gauss"]], ["ply_opacity", inp["gauss"]],
            ["pth_structure", inp["tensor_data"]], ["hit_counts", inp["vox"]],
            ["occupancy_ply", inp["occ"], "--out", "occ.ply"],
            ["cameras_ply", inp["scene"], "--out", "cams.ply"],
            ["label_distribution", inp["semantics"]]]
    for argv in runs:
        sub = tmp_path / argv[0]
        dirs, outs = _both("debug_tools", lambda d: [
            os.path.join(d, a) if a.endswith(".ply") and not os.path.isabs(a) else a
            for a in argv], sub)
        assert outs["port"] == outs["jax"] and outs["jax"], argv[0]
        if argv[-1].endswith(".ply"):
            _same_files(dirs, argv[-1])


def case_visualize_lseg_features(inp, tmp_path):
    dirs, outs = _both("visualize_lseg_features", lambda d: [
        "--features", inp["feats"], "--out_dir", d, "--images", inp["images"],
        "--alpha", "0.4"], tmp_path)
    assert outs["port"] == outs["jax"] and outs["jax"].count("[OK]") == VIEWS
    files = sorted(os.listdir(dirs["jax"]))
    assert len(files) == 2 * VIEWS and files == sorted(os.listdir(dirs["port"]))
    _same_files(dirs, *files)


CASES = {
    "prepare_tensor_data": case_prepare_tensor_data,
    "project_features_splat": _project("splat"),
    "project_features_dda": _project("dda"),
    "build_sparse_occupancy": case_build_sparse_occupancy,
    "aggregate_voxel_colors_onthefly": case_aggregate_voxel_colors_onthefly,
    "voxeltovoxel_logits": case_voxeltovoxel_logits,
    "extract_gaussian_centers": case_extract_gaussian_centers,
    "logit_confidence_map": case_logit_confidence_map,
    "analyze_gaussian_semantics": case_analyze_gaussian_semantics,
    "minkowski_voxel_grid": _grid_case("minkowski_voxel_grid", "--opacity_threshold", "0.4",
                                       "--target_voxels", "60"),
    "minkowski_voxel_grid_from_ply": _grid_case("minkowski_voxel_grid_from_ply",
                                                "--cell_size", "0.2"),
    "minkowski_voxel_grid_density_filtered": _grid_case(
        "minkowski_voxel_grid_density_filtered", "--cell_size", "0.2", "--density_eps", "0.4",
        "--density_min_neighbors", "3", "--opacity_threshold", "0.5"),
    "minkowski_mesh_voxel_grid": _grid_case("minkowski_mesh_voxel_grid", "--num_samples",
                                            "3000", "--cell_size", "0.15"),
    "detect_surface": case_detect_surface,
    "export_gaussians": case_export_gaussians,
    "export_gaussian_ellipsoids": case_export_gaussian_ellipsoids,
    "gaussian_color_stats": case_gaussian_color_stats,
    "scale_sparsity_filter": case_scale_sparsity_filter,
    "dist_to_mesh_filter": case_dist_to_mesh_filter,
    "debug_tools": case_debug_tools,
    "visualize_lseg_features": case_visualize_lseg_features,
}


def test_every_script_has_a_case():
    assert {c.rsplit("_splat", 1)[0].rsplit("_dda", 1)[0] for c in CASES} == set(SCRIPTS)
    for name in SCRIPTS:
        jax_mod, port_mod = _scripts(name)
        assert callable(port_mod.main), name


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_the_jax_script(case, inputs, tmp_path):
    CASES[case](inputs, tmp_path)


@pytest.mark.parametrize("name", DEVICE_SCRIPTS)
def test_device_twins_need_a_card_or_device_cpu(name, inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    argv = {"prepare_tensor_data": ["--lseg_dir", inputs["feats"], "--scaled_camera_params",
                                    inputs["cams"], "--occupancy", inputs["occ"],
                                    "--voxel_size", "0.2", "--grid_origin", "0", "0", "0",
                                    "--output", str(tmp_path / "td.pt")],
            "project_features": ["--tensor_data", inputs["tensor_data"]],
            "build_sparse_occupancy": ["--voxel_ply", inputs["grid"]],
            "aggregate_voxel_colors_onthefly": ["--voxel_ply", inputs["grid"], "--images_dir",
                                                inputs["images"], "--camera_params",
                                                inputs["cams"]],
            "voxeltovoxel_logits": ["--vox", inputs["vox"], "--prompt", "wall", "--out",
                                    str(tmp_path / "sem.npz")]}[name]
    _, port = _scripts(name)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        port.main(argv)
    assert not os.listdir(tmp_path)                  # nothing written


def test_check_env_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert check_env.main([]) == 1
    out = capsys.readouterr()
    assert f"torch {torch.__version__}" in out.out and "no card" in out.err
    # its K1 input: a real scene whose plain blend covers the frame
    img, alpha = check_env.B.blend_tiles(*check_env.k1_inputs("cpu"))
    assert img.shape == (check_env.H, check_env.W, check_env.CH) and float(alpha.max()) > 0.9


@pytest.mark.cuda
def test_check_env_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert check_env.main([]) == 0
    assert capsys.readouterr().out.rstrip().endswith("ALL OK")
