"""SLIC and the region merge of the port (segsplat_tpu_torch/pipeline/segment.py)
against the JAX package's (segsplat_tpu/pipeline/segment.py), and the
segment → track CLI twin against scripts/prepare_pseudo_label.py.

Tolerances: one assignment step from the same centroids gives the same label
wherever the two nearest distinct centroids' squared distances differ by more
than 1e-5. The full 8 iterations agree on ≥ 99.5 % of pixels: the port sums
each centroid's pixels in input order (ops/voxelize.segment_sum), XLA in its
one-hot product's order, so centroids differ in their last bits and a pixel
nearly equidistant from two may change its label. The merge is numpy in both
packages: the same labels give the same map bit for bit."""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segsplat_tpu.pipeline import segment as JS
from segsplat_tpu_torch.pipeline import segment as TS
from test_segment import _shapes_frame
from _torch_port import torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


@functools.lru_cache(maxsize=None)
def _sweep_frame(i: int) -> np.ndarray:
    """Frame ``i`` of the pseudo-label loop's default scene at 96², rendered
    by the port's dense backend and quantised to uint8 as the loop writes it."""
    from segsplat_tpu_torch import pseudo_label_loop as L

    g = L.build_objects(np.random.default_rng(0))
    Rs, ts, fx, fy = L.orbit_cameras(8, 96, 96)
    rgbs, _ = L.render_sweep(g, Rs[i:i + 1], ts[i:i + 1], fx, fy, 96, 96, device="cpu")
    return (rgbs[0] * 255).astype(np.uint8)


def _images():
    return {"shapes": _shapes_frame()[0], "sweep": _sweep_frame(2).copy()}


def _float(img):
    return img.astype(np.float32) / 255.0


def _jax_assign(feat, cell_y, cell_x, cent, gy, gx):
    """The JAX package's assignment (segment.py:86-97, the scan body's first
    half) in jnp, on given centroids."""
    feat, cent = jnp.asarray(feat), jnp.asarray(cent)
    H, W = feat.shape[:2]
    best_d = jnp.full((H, W), jnp.inf)
    best_k = jnp.zeros((H, W), jnp.int32)
    for dy, dx in TS.OFFSETS:
        ny = jnp.clip(jnp.asarray(cell_y) + dy, 0, gy - 1)
        nx = jnp.clip(jnp.asarray(cell_x) + dx, 0, gx - 1)
        k = ny * gx + nx
        d = jnp.sum((feat - cent[k]) ** 2, axis=-1)
        take = d < best_d
        best_d = jnp.where(take, d, best_d)
        best_k = jnp.where(take, k, best_k)
    return np.asarray(best_k)


def _clear_margin(feat, cell_y, cell_x, cent, gy, gx, tol=1e-5):
    """Pixels whose nearest centroid beats every other distinct candidate by
    more than ``tol`` in squared distance."""
    k = torch.stack([torch.clamp(cell_y + dy, 0, gy - 1) * gx
                     + torch.clamp(cell_x + dx, 0, gx - 1) for dy, dx in TS.OFFSETS])
    d = ((feat[None] - cent[k]) ** 2).sum(-1).double()
    best = d.min(0).values
    best_k = torch.gather(k, 0, d.argmin(0, keepdim=True))
    other = torch.where(k == best_k, torch.inf, d).min(0).values
    return (other - best > tol).numpy()


@pytest.mark.parametrize("n_segments", (128, 256))
@pytest.mark.parametrize("name", ("shapes", "sweep"))
def test_one_assignment_step_matches_jax(name, n_segments):
    img = _float(_images()[name])
    H, W = img.shape[:2]
    gy, gx = TS.grid_dims(H, W, n_segments)
    assert (gy, gx) == JS._grid_dims(H, W, n_segments)
    feat, cell_y, cell_x, cent = TS.slic_features(torch.from_numpy(img), gy, gx, 0.25)
    # from the seeds: the JAX function's first assignment
    got = TS.slic_assign(feat, cell_y, cell_x, cent, gy, gx).numpy()
    want = np.asarray(JS._slic_assign(jnp.asarray(img), gy, gx, 1, 0.25))
    clear = _clear_margin(feat, cell_y, cell_x, cent, gy, gx)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])
    # from centroids three updates on: the JAX assignment fed the same ones
    for _ in range(3):
        cent = TS.slic_update(feat, TS.slic_assign(feat, cell_y, cell_x, cent, gy, gx), cent)
    got = TS.slic_assign(feat, cell_y, cell_x, cent, gy, gx).numpy()
    want = _jax_assign(feat.numpy(), cell_y.numpy(), cell_x.numpy(), cent.numpy(), gy, gx)
    clear = _clear_margin(feat, cell_y, cell_x, cent, gy, gx)
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("n_segments", (128, 256))
@pytest.mark.parametrize("name", ("shapes", "sweep"))
def test_slic_agrees_with_jax_over_all_iterations(name, n_segments):
    img = _float(_images()[name])
    gy, gx = TS.grid_dims(*img.shape[:2], n_segments)
    got = TS.slic_labels(torch.from_numpy(img), gy, gx, 8, 0.25).numpy()
    want = np.asarray(JS._slic_assign(jnp.asarray(img), gy, gx, 8, 0.25))
    assert got.dtype == np.int64 and got.shape == want.shape
    differ = int((got != want).sum())
    print(f"{name} n_segments={n_segments}: {differ} of {got.size} labels differ")
    assert differ <= 0.005 * got.size
    again = TS.slic_labels(torch.from_numpy(img), gy, gx, 8, 0.25).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("cfg", (dict(), dict(merge_thresh=0.15, min_pixels=40),
                                 dict(merge_thresh=0.3, min_pixels=200)))
@pytest.mark.parametrize("name", ("shapes", "sweep"))
def test_merge_regions_is_bit_identical(name, cfg):
    img = _float(_images()[name])
    gy, gx = JS._grid_dims(*img.shape[:2], 128)
    labels = np.asarray(JS._slic_assign(jnp.asarray(img), gy, gx, 8, 0.25))
    want = JS._merge_regions(labels, img, JS.SegmentConfig(**cfg))
    got = TS.merge_regions(labels, img, TS.SegmentConfig(**cfg))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_segment_image_matches_jax_and_recovers_shapes():
    img, rect, disk = _shapes_frame()
    ids = TS.segment_image(img, TS.SegmentConfig(n_segments=128), device="cpu")
    np.testing.assert_array_equal(ids, JS.segment_image(img, JS.SegmentConfig(n_segments=128)))
    assert ids.min() >= 1
    rect_ids = ids[rect].reshape(-1)
    rect_mode = np.bincount(rect_ids).argmax()
    assert (rect_ids == rect_mode).mean() > 0.9
    disk_ids = ids[disk]
    disk_mode = np.bincount(disk_ids).argmax()
    assert (disk_ids == disk_mode).mean() > 0.9
    bg_mode = np.bincount(ids[2:10, 2:10].reshape(-1)).argmax()
    assert len({int(rect_mode), int(disk_mode), int(bg_mode)}) == 3
    assert len(np.unique(ids)) < 20


def _read_dir(d):
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


def test_segment_then_track_cli_writes_the_same_files(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import prepare_pseudo_label as jax_cli

    from segsplat_tpu_torch import prepare_pseudo_label as cli

    frames = tmp_path / "images"
    frames.mkdir()
    for i in range(3):
        Image.fromarray(_shapes_frame(shift=3 * i)[0]).save(frames / f"f_{i:03d}.png")
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        seg, trk = str(tmp_path / f"seg_{name}"), str(tmp_path / f"mask_{name}")
        main(["segment", "--images", str(frames), "--out", seg, "--n_segments", "128", *extra])
        main(["track", "--masks", seg, "--out", trk, "--iou_threshold", "0.3"])
        out[name] = (_read_dir(seg), _read_dir(trk))
    for got, want in zip(out["port"], out["jax"]):
        assert list(got) == list(want) and len(got) == 3
        for f in want:
            assert got[f].dtype == want[f].dtype
            np.testing.assert_array_equal(got[f], want[f])
    # the disk keeps one stable id across the frames
    ids = [np.bincount(m[_shapes_frame(shift=3 * i)[2]]).argmax()
           for i, m in enumerate(out["port"][1].values())]
    assert ids[0] == ids[1] == ids[2] != 0
