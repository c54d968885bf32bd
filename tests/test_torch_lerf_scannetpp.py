"""The LERF-Masked and ScanNet++ CLI twins of the port against the JAX scripts
on the same small directories: render_lerf_mask (query mask → IoA selection →
softmax export), eval_lerf_mask (mask IoU, boundary IoU, CSV),
render_scannetpp_gt (annotated mesh → ``*_labels.pt``) and eval_scannetpp
(mIoU, fwIoU). The same masks, CSVs, label maps and printed metrics."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import eval_lerf_mask as jax_eval_lerf  # noqa: E402
import eval_scannetpp as jax_eval_scannetpp  # noqa: E402
import render_lerf_mask as jax_render_lerf  # noqa: E402
import render_scannetpp_gt as jax_render_gt  # noqa: E402

from segsplat_tpu_torch import eval_lerf_mask, eval_scannetpp, render_lerf_mask  # noqa: E402
from segsplat_tpu_torch import pseudo_label_loop as L  # noqa: E402
from segsplat_tpu_torch import render_scannetpp_gt  # noqa: E402
from segsplat_tpu_torch.io.artifacts import load_label_map  # noqa: E402
from segsplat_tpu_torch.io.ply import save_gaussian_ply  # noqa: E402
from _torch_port import torch_threads  # noqa: E402

SIZE, FRAMES, ITER = 64, 4, 3


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
def lerf_scene(tmp_path_factory):
    """The pseudo-label loop's 5-object scene as a COLMAP dataset at 64², and a
    model dir whose Gaussians carry their object's one-hot identity (×8) and a
    codebook whose first rows are those directions: classes are objects."""
    root = tmp_path_factory.mktemp("lerf")
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
    return dict(root=str(root), model=str(model), gts=gts)


def test_lerf_mask_clis_write_the_same_masks_and_scores(lerf_scene, tmp_path):
    root, model, gts = lerf_scene["root"], lerf_scene["model"], lerf_scene["gts"]
    qmask = str(tmp_path / "query.png")
    Image.fromarray((gts[0] == 2).astype(np.uint8) * 255).save(qmask)
    common = ["-s", root, "-m", model, "--iteration", str(ITER), "--query_mask", qmask]
    _quiet(jax_render_lerf.main, [*common, "--out_name", "jax_mask"])
    _quiet(render_lerf_mask.main, [*common, "--out_name", "port_mask", "--device", "cpu"])
    dirs = {k: os.path.join(model, f"{k}_mask", f"ours_{ITER}") for k in ("jax", "port")}
    names = sorted(f for f in os.listdir(dirs["jax"]) if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(dirs["port"]) if f.endswith(".png"))
    assert len(names) == FRAMES
    for f in names:
        want = np.asarray(Image.open(os.path.join(dirs["jax"], f)))
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(dirs["port"], f))),
                                      want)
    assert np.asarray(Image.open(os.path.join(dirs["port"], names[0]))).any()
    with open(os.path.join(dirs["port"], "_weights_provenance.json")) as f:
        assert "grounding:precomputed_mask" in f.read()

    # eval: GT masks of object 2 under gt/<scene>/, predictions under <pred>/<scene>/
    gt_dir = tmp_path / "gt" / "synthetic"
    gt_dir.mkdir(parents=True)
    for f, gt in zip(names, gts):
        Image.fromarray((gt == 2).astype(np.uint8) * 255).save(gt_dir / f)
    out = {}
    for k, main in (("jax", jax_eval_lerf.main), ("port", eval_lerf_mask.main)):
        pred_root = tmp_path / f"pred_{k}"
        pred_root.mkdir()
        os.symlink(dirs[k], pred_root / "synthetic")
        csv = str(tmp_path / f"{k}.csv")
        out[k] = (_quiet(main, ["--gt_root", str(tmp_path / "gt"), "--pred_root",
                                str(pred_root), "--scenes", "synthetic", "--out_csv", csv]),
                  open(csv).read())
    assert out["port"][0].replace("port", "jax") == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert "mIoU=" in out["port"][0] and len(out["port"][1].splitlines()) == FRAMES + 1


def test_lerf_mask_clis_ground_the_same_text_query(lerf_scene, tmp_path):
    """--query_text on frame-0 feature maps: both packages ground the prompt
    with the same hash embeddings (no CLIP weights here) and write the same
    masks."""
    from segsplat_tpu_torch.pipeline.query import hash_prompt_embeddings

    root, model, gts = lerf_scene["root"], lerf_scene["model"], lerf_scene["gts"]
    C = 12
    emb_p, emb_n = hash_prompt_embeddings(["chair", "object"], C)
    fmap = np.tile(emb_n, (SIZE // 2, SIZE // 2, 1)).astype(np.float32)
    obj = np.pad(gts[0] == 3, 4)                         # the object, grown by 4 px
    obj = np.any([np.roll(np.roll(obj, dy, 0), dx, 1) for dy in range(-4, 5)
                  for dx in range(-4, 5)], axis=0)[4:-4, 4:-4]
    fmap[obj[::2, ::2]] = emb_p                          # under the prompt
    feat = str(tmp_path / "frame0.npy")
    np.save(feat, np.transpose(fmap, (2, 0, 1)))
    common = ["-s", root, "-m", model, "--iteration", str(ITER), "--query_text", "chair",
              "--lseg_feat", feat]
    logs = {"jax": _quiet(jax_render_lerf.main, [*common, "--out_name", "jax_text"]),
            "port": _quiet(render_lerf_mask.main, [*common, "--out_name", "port_text",
                                                   "--device", "cpu"])}
    grounded = [[ln for ln in logs[k].splitlines() if ln.startswith("[INFO]")]
                for k in ("jax", "port")]
    assert grounded[0] == grounded[1] and "[INFO] selected object ids: [3]" in grounded[1]
    dirs = [os.path.join(model, f"{k}_text", f"ours_{ITER}") for k in ("jax", "port")]
    for f in sorted(os.listdir(dirs[0])):
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(dirs[1], f))),
                                          np.asarray(Image.open(os.path.join(dirs[0], f))))


def _mesh_ply(path, verts, faces, vlabels):
    """A binary little-endian PLY with a per-vertex int label and triangle
    faces (uchar counts, int indices)."""
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\nproperty float x\nproperty float y\n"
              "property float z\nproperty int label\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    v = np.zeros(len(verts), [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("label", "<i4")])
    v["x"], v["y"], v["z"], v["label"] = verts[:, 0], verts[:, 1], verts[:, 2], vlabels
    f = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
    f["n"], f["i"] = 3, faces
    with open(path, "wb") as fh:
        fh.write(header.encode() + v.tobytes() + f.tobytes())


def test_scannetpp_clis_write_the_same_labels_and_metrics(tmp_path):
    import json

    rng = np.random.default_rng(7)
    n_tri = 900
    centres = rng.uniform(-1.5, 1.5, (n_tri, 3)) * [1, 1, 0.5] + [0, 0, 3.0]
    verts = (centres[:, None, :] + rng.normal(0, 0.15, (n_tri, 3, 3))).reshape(-1, 3)
    faces = np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)
    vlabels = np.repeat(rng.integers(1, 12, n_tri), 3).astype(np.int32)
    vlabels[1::3] = rng.integers(1, 12, n_tri)            # majority-of-3 at work
    mesh = str(tmp_path / "mesh.ply")
    _mesh_ply(mesh, verts.astype(np.float32), faces, vlabels)
    images = {}
    for i, yaw in enumerate((0.0, 0.15)):
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        images[str(i)] = {"name": f"view{i}.jpg", "camera_id": "0", "R": R.tolist(),
                          "tvec": [0.1 * i, 0.0, 0.2]}
    cams = str(tmp_path / "cams.json")
    with open(cams, "w") as f:
        json.dump({"images": images, "cameras": {"0": {"params": [70.0, 48.0, 40.0]}}}, f)
    common = ["--mesh", mesh, "--camera_params", cams, "--image_size", "192", "160",
              "--downsample", "0.5", "--max_tiles_per_axis", "4", "--max_per_tile", "32",
              "--face_chunk", "400"]
    logs = {}
    for k, main, extra in (("jax", jax_render_gt.main, []),
                           ("port", render_scannetpp_gt.main, ["--device", "cpu"])):
        logs[k] = _quiet(main, [*common, "--out_dir", str(tmp_path / k), *extra])
    assert logs["port"].replace("port", "jax") == logs["jax"]
    assert "[WARN]" in logs["port"]                      # the overflow is reported
    for i in range(2):
        got = load_label_map(str(tmp_path / "port" / f"view{i}_labels.pt"))
        want = load_label_map(str(tmp_path / "jax" / f"view{i}_labels.pt"))
        assert got.shape == (80, 96) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert ((got > 0) & (got < 255)).mean() > 0.1

    # a perturbed prediction against the GT, and the GT against itself
    pred = tmp_path / "pred"
    pred.mkdir()
    for i in range(2):
        lab = load_label_map(str(tmp_path / "port" / f"view{i}_labels.pt")).copy()
        lab[::3] = rng.integers(0, 12, lab[::3].shape)
        torch.save({"label_indices": torch.from_numpy(lab)}, pred / f"view{i}_labels.pt")
    for pred_dir, miou in ((str(tmp_path / "port"), "mIoU 1.0000"), (str(pred), "mIoU 0.")):
        args = ["--pred_dir", pred_dir, "--gt_dir", str(tmp_path / "jax"),
                "--num_classes", "12", "--ignore_label", "255"]
        got = _quiet(eval_scannetpp.main, args)
        assert got == _quiet(jax_eval_scannetpp.main, args)
        assert miou in got
