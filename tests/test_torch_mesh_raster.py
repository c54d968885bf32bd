"""The mesh label rasterizer of the port (segsplat_tpu_torch/ops/mesh_raster.py,
torch ops on the port's binning) against the JAX package's
(segsplat_tpu/ops/mesh_raster.py) and tests/test_mesh_raster.py's numpy
oracle: labels exact, depth within rtol 1e-5, the overflow equal, in one face
chunk and in several; and tests/test_miou_loop.py's closed loop (the Gaussian
logit rasterizer against the mesh GT) on the port's dense backend."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.ops import mesh_raster as JM
from segsplat_tpu_torch.eval.metrics import confusion_matrix, iou_per_class
from segsplat_tpu_torch.ops import mesh_raster as TM
from segsplat_tpu_torch.ops.rasterize import rasterize
from test_mesh_raster import _two_triangle_scene, oracle_mesh_labels
from test_miou_loop import _quad
from _torch_port import torch_threads

t = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


def _soup(seed, n_tri, size, f, spread=1.0):
    rng = np.random.default_rng(seed)
    verts = ((rng.random((n_tri * 3, 3)) * 2 - 1) * spread).astype(np.float32)
    verts[:, 2] = verts[:, 2] * 0.5 + 2.0
    faces = np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)
    labels = rng.integers(0, 20, n_tri).astype(np.int32)
    a = 0.1 * seed                                      # a yaw and a shift
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    vm[:3, 3] = [0.05, -0.1, 0.2]
    return verts, faces, labels, vm, f, f, size / 2, size / 2, size, size


def _compare(got, want, rtol=1e-5):
    g_lab, g_d, g_of = (x.numpy() for x in got)
    w_lab, w_d, w_of = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(g_lab, w_lab)
    fin = np.isfinite(w_d)
    np.testing.assert_array_equal(np.isfinite(g_d), fin)
    np.testing.assert_allclose(g_d[fin], w_d[fin], rtol=rtol)
    assert int(g_of) == int(w_of)
    assert g_lab.dtype == np.int32 and g_d.dtype == np.float32


def test_two_triangles_match_jax_and_the_oracle():
    verts, faces, labels, vm, fx, fy, cx, cy, W, H = _two_triangle_scene()
    kw = dict(max_tiles_per_axis=4, max_per_tile=64, tile_chunk=2)
    got = TM.rasterize_mesh_labels(t(verts), t(faces), t(labels), t(vm), fx, fy, cx, cy,
                                   W, H, **kw)
    want = JM.rasterize_mesh_labels(jnp.asarray(verts), jnp.asarray(faces),
                                    jnp.asarray(labels), jnp.asarray(vm), fx, fy, cx, cy,
                                    W, H, **kw)
    _compare(got, want)
    o_lab, o_d = oracle_mesh_labels(verts, faces, labels, vm, fx, fy, cx, cy, W, H)
    np.testing.assert_array_equal(got[0].numpy(), o_lab)
    assert (o_lab == 7).any() and (o_lab == 3).any() and (o_lab == TM.MISS_LABEL).any()


@pytest.mark.parametrize("face_chunk", (10_000, 50, 17))
@pytest.mark.parametrize("scene", ("soup", "overflowing"))
def test_chunked_matches_jax(scene, face_chunk):
    """One chunk and several (the port leaves the tail chunk unpadded), with
    and without faces past the per-tile cap."""
    args = _soup(1, 120, 48, 28.0) if scene == "soup" else _soup(2, 300, 40, 40.0, 0.4)
    K = 256 if scene == "soup" else 16         # 120 faces cannot pass 256 in a tile
    kw = dict(max_tiles_per_axis=4, max_per_tile=K, tile_chunk=3)
    verts, faces, labels, vm, fx, fy, cx, cy, W, H = args
    got = TM.rasterize_mesh_labels_chunked(t(verts), faces, labels, t(vm), fx, fy, cx, cy,
                                           W, H, face_chunk=face_chunk, **kw)
    want = JM.rasterize_mesh_labels_chunked(jnp.asarray(verts), faces, labels,
                                            jnp.asarray(vm), fx, fy, cx, cy, W, H,
                                            face_chunk=face_chunk, **kw)
    _compare(got, want)
    assert (int(got[2]) > 0) == (scene == "overflowing")
    assert (got[0] != TM.MISS_LABEL).float().mean() > 0.05


def test_faces_behind_znear_and_clipped_extent_match_jax():
    """A face through the camera plane is dropped, and one spanning more than
    max_tiles_per_axis tiles is clipped, as in the JAX package."""
    verts = np.array([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.0, 0.5, -1.0],      # crosses z=0
                      [-3.0, -3.0, 3.0], [3.0, -3.0, 3.0], [0.0, 3.0, 3.0],       # huge
                      [-0.2, -0.2, 1.5], [0.2, -0.2, 1.5], [0.0, 0.2, 1.5]], np.float32)
    faces = np.arange(9, dtype=np.int32).reshape(3, 3)
    labels = np.array([1, 2, 3], np.int32)
    vm = np.eye(4, dtype=np.float32)
    kw = dict(max_tiles_per_axis=2, max_per_tile=8, tile_chunk=4)
    got = TM.rasterize_mesh_labels(t(verts), t(faces), t(labels), t(vm), 30.0, 30.0, 32.0,
                                   32.0, 64, 64, **kw)
    want = JM.rasterize_mesh_labels(jnp.asarray(verts), jnp.asarray(faces),
                                    jnp.asarray(labels), jnp.asarray(vm), 30.0, 30.0, 32.0,
                                    32.0, 64, 64, **kw)
    _compare(got, want)
    lab = got[0].numpy()
    assert not (lab == 1).any() and (lab == 3).any()
    o_lab, _ = oracle_mesh_labels(verts, faces, labels, vm, 30.0, 30.0, 32.0, 32.0, 64, 64)
    assert ((o_lab == 2) & (lab != 2)).any()           # the clip drops some of face 2


def test_gaussian_semantics_match_mesh_gt_miou_on_the_dense_backend():
    """tests/test_miou_loop.py's construction on the port: two labelled quads
    and Gaussians tiling them with one-hot logits; the port's mesh GT equals
    JAX's, and the dense rasterizer agrees with it (mIoU > 0.8)."""
    W, H = 96, 80
    fx = fy = 90.0
    vA, fA = _quad(-1.4, -0.15, -0.9, 0.9, 3.0)
    vB, fB = _quad(0.15, 1.4, -0.9, 0.9, 3.0)
    verts = np.concatenate([vA, vB])
    faces = np.concatenate([fA, fB + 4])
    face_labels = np.array([1, 1, 2, 2], np.int32)
    vm = np.eye(4, dtype=np.float32)
    kw = dict(max_tiles_per_axis=6, max_per_tile=64, tile_chunk=5)
    gt = TM.rasterize_mesh_labels(t(verts), t(faces), t(face_labels), t(vm), fx, fy,
                                  W / 2, H / 2, W, H, **kw)[0].numpy()
    want = JM.rasterize_mesh_labels(jnp.asarray(verts), jnp.asarray(faces),
                                    jnp.asarray(face_labels), jnp.asarray(vm), fx, fy,
                                    W / 2, H / 2, W, H, **kw)[0]
    np.testing.assert_array_equal(gt, np.asarray(want))
    assert (gt == 1).sum() > 400 and (gt == 2).sum() > 400

    def carpet(x0, x1, y0, y1, z, n=24):
        xs, ys = np.meshgrid(np.linspace(x0, x1, n), np.linspace(y0, y1, n))
        return np.stack([xs.ravel(), ys.ravel(), np.full(n * n, z)], axis=1)

    pts = np.concatenate([carpet(-1.4, -0.15, -0.9, 0.9, 3.0),
                          carpet(0.15, 1.4, -0.9, 0.9, 3.0)]).astype(np.float32)
    n = len(pts)
    labels = np.repeat([1, 2], n // 2)
    logits = np.full((n, 3), -10.0, np.float32)
    logits[np.arange(n), labels] = 10.0
    out = rasterize(t(pts), torch.full((n, 3), 0.05), torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
                    torch.full((n,), 0.95), t(logits), t(vm), fx, fy, W / 2, H / 2, W, H,
                    max_tiles_per_axis=6, max_per_tile=128, tile_chunk=5, backend="dense")
    sem = out["image"].numpy()
    alpha = out["alpha"].numpy()
    pred = np.where(alpha > 0.5, np.argmax(sem, axis=-1), TM.MISS_LABEL)
    mask = gt != TM.MISS_LABEL
    conf = confusion_matrix(np.where(pred == TM.MISS_LABEL, 0, pred)[mask], gt[mask],
                            num_classes=3)
    miou = float(np.nanmean(iou_per_class(conf)[1:]))
    assert (pred[mask] == gt[mask]).mean() > 0.9
    assert miou > 0.8
