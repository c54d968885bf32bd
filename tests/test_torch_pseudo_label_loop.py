"""The pseudo-label loop twin (segsplat_tpu_torch/pseudo_label_loop.py) against
scripts/pseudo_label_loop.py: its GT sweep equals the JAX sweep's on ≥ 99.9 %
of pixels (RGB within 1e-4), at 3 + 5 and 3 + 20 channels; the COLMAP dataset
it writes is the same bytes; its LERF protocol and its identity
classification give the JAX script's results on the same inputs; and its
miniature (8 frames, 64², 80 iterations, capacity 2048, on the CPU) meets
tests/test_pseudo_label_loop.py's thresholds."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts import pseudo_label_loop as J  # noqa: E402

from segsplat_tpu_torch import pseudo_label_loop as L  # noqa: E402
from _torch_port import torch_threads  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


@pytest.mark.parametrize("n_objects,layout,textured,backend",
                         ((5, "fixed", False, "dense"), (20, "random", True, "dense"),
                          (20, "random", True, "cuda")))
def test_gt_sweep_matches_jax(n_objects, layout, textured, backend, monkeypatch):
    """The dense backend (the twin's on the CPU) and the kernel path's plain
    K1 (``cuda`` on CPU tensors, at 23 channels) against the JAX "xla" sweep."""
    if backend == "cuda":
        monkeypatch.setattr(L, "raster_backend", lambda device: "cuda")
    g_j = J.build_objects(np.random.default_rng(0), n_objects=n_objects, layout=layout,
                          textured=textured)
    g = L.build_objects(np.random.default_rng(0), n_objects=n_objects, layout=layout,
                        textured=textured)
    for k in g_j:
        np.testing.assert_array_equal(g[k], g_j[k])
    Rs, ts, fx, fy = L.orbit_cameras(6, 80, 80)
    Rs_j, ts_j, fx_j, _ = J.orbit_cameras(6, 80, 80)
    np.testing.assert_array_equal(np.stack(Rs), np.stack(Rs_j))
    assert fx == fx_j
    rgbs, gts = L.render_sweep(g, Rs, ts, fx, fy, 80, 80, device="cpu")
    rgbs_j, gts_j = J.render_sweep(g_j, Rs_j, ts_j, fx, fy, 80, 80)
    np.testing.assert_allclose(rgbs, rgbs_j, atol=1e-4)
    same = (gts == gts_j).mean()
    print(f"GT sweep, {n_objects} objects, {backend}: {same:.6f} of pixels equal")
    assert same >= 0.999
    assert len(np.unique(gts)) >= min(n_objects, 5) + 1


def test_colmap_scene_is_the_same_bytes(tmp_path):
    g = L.build_objects(np.random.default_rng(0))
    Rs, ts, fx, fy = L.orbit_cameras(4, 48, 48)
    rgbs = np.random.default_rng(1).random((4, 48, 48, 3)).astype(np.float32)
    L.write_colmap_scene(str(tmp_path / "port"), g, Rs, ts, fx, fy, rgbs)
    J.write_colmap_scene(str(tmp_path / "jax"), g, Rs, ts, fx, fy, rgbs)
    files = [os.path.join(d, f) for d in ("sparse/0", "images")
             for f in sorted(os.listdir(tmp_path / "jax" / d))]
    assert len(files) == 3 + 4
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def _identity_scene(seed: int, frames: int = 4, size: int = 40, n_objects: int = 5):
    """Seeded GT maps (5 block objects on background), alphas (half of
    object 3 below 0.5, a background band above it, a corner at 0.5) and 256-class logit maps
    whose argmax on object k is a class id of its own (object 2 split over
    two ids, object 5 sharing object 4's on one frame), with noise."""
    rng = np.random.default_rng(seed)
    ids = {1: [13], 2: [40, 41], 3: [77], 4: [120], 5: [201]}
    gts, alphas, logit_maps = [], [], []
    for f in range(frames):
        gt = np.zeros((size, size), np.int32)
        for k in range(1, n_objects + 1):
            y, x = rng.integers(0, size - 12, 2)
            gt[y:y + 10 + k % 3, x:x + 9 + f % 2] = k
        alpha = np.where(gt > 0, 0.9, 0.1).astype(np.float32)
        alpha[:, :3] = 0.7
        alpha[size // 2:, -8:] = 0.5                  # on the gate's edge
        alpha[gt == 3] = np.where(np.arange(size) < size // 2, 0.3, 0.9)[None].repeat(
            size, 0)[gt == 3]
        logits = rng.normal(0.0, 1.0, (256, size, size)).astype(np.float32)
        for k, cls in ids.items():
            cls = ids[4] if (k == 5 and f == 2) else cls
            ys, xs = np.nonzero(gt == k)
            pick = np.asarray(cls)[rng.integers(0, len(cls), ys.size)]
            logits[pick, ys, xs] += 4.0
        gts.append(gt)
        alphas.append(alpha)
        logit_maps.append(logits)
    return logit_maps, gts, alphas


@pytest.mark.parametrize("seed", (0, 3))
def test_lerf_protocol_eval_matches_jax(seed):
    """The same logit maps, GT maps and alphas through the two LERF protocols
    (grounding, IoA selection, argmax-membership export, the control prompt)
    give the same result, key for key."""
    logit_maps, gts, alphas = _identity_scene(seed)
    port = L.lerf_protocol_eval(logit_maps, gts, alphas, seed=seed, device="cpu")
    ref = J.lerf_protocol_eval(logit_maps, gts, alphas, seed=seed)
    print(port)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == ref[k], (k, port[k], ref[k])
    assert port["lerf_mask_iou"] > 0.5          # objects were selected and exported


def test_predict_identity_maps_matches_jax(monkeypatch):
    """The classification step of both predict_identity_maps on the same fixed
    renders (16 identity channels and alpha per view, the render replaced):
    codebook logits, the first-maximum argmax (a codebook row duplicated so
    that exact ties occur) and the alpha gate."""
    import jax.numpy as jnp
    import segsplat_tpu.render
    import torch
    from types import SimpleNamespace

    rng = np.random.default_rng(5)
    H = W = 32
    objs = [rng.normal(0, 1, (16, H, W)).astype(np.float32) for _ in range(3)]
    alphas = [rng.random((H, W)).astype(np.float32) for _ in range(3)]
    code_book = rng.normal(0, 1, (256, 16)).astype(np.float32)
    top = int(np.argmax(np.einsum("co,ohw->chw", code_book, objs[0]).max(axis=(1, 2))))
    code_book[255] = code_book[top]                     # ties with ``top``, a lower id
    calls = iter(range(10 ** 6))

    def fixed(backend):
        def render_fixed(table, cam, bg, **kw):
            i = next(calls) % 3
            if backend == "jax":
                return {"render_object": jnp.asarray(objs[i]), "alpha": jnp.asarray(alphas[i])}
            return {"render_object": torch.from_numpy(objs[i]),
                    "alpha": torch.from_numpy(alphas[i])}
        return render_fixed

    Rs, ts, fx, fy = L.orbit_cameras(3, H, W)
    monkeypatch.setattr(segsplat_tpu.render, "render", fixed("jax"))
    ref = J.predict_identity_maps(
        SimpleNamespace(table=None, code_book=jnp.asarray(code_book)), Rs, ts, fx, fy, H, W, {})
    calls = iter(range(10 ** 6))
    monkeypatch.setattr(L, "render", fixed("torch"))
    port = L.predict_identity_maps(SimpleNamespace(table=None,
                                                   code_book=torch.from_numpy(code_book)),
                                   Rs, ts, fx, fy, H, W, {}, device="cpu")
    assert port[1] == ref[1] == 257
    for p, r in zip(port[0], ref[0]):                   # class maps
        assert p.dtype == r.dtype and np.array_equal(p, r)
    for p, r in zip(port[2], ref[2]):                   # logit maps
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)
    for p, r in zip(port[3], ref[3]):                   # alphas
        assert np.array_equal(p, r)
    assert (port[0][0] == top + 1).any() and not (port[0][0] == 256).any()
    assert (port[0][0] == 0).any()


@pytest.mark.filterwarnings("ignore")
def test_pseudo_label_loop_miniature(tmp_path):
    """tests/test_pseudo_label_loop.py's thresholds, at 64² and 80 iterations
    in place of its 96² and 150: the port's dense blend takes about 1.1 s an
    iteration at 96² on one CPU thread, and this size keeps the file within a
    minute (consistency 0.88, grouped 0.32, background 0.94, LERF 0.21, control
    export 0.004 at this size). Two torch threads: the test is one long
    sequence of mid-sized tensor ops."""
    with torch_threads(2):
        r = L.run_loop(str(tmp_path), frames=8, H=64, W=64, iterations=80, capacity=2048,
                       quiet=True, device="cpu")
    assert r["tracker_consistency"] > 0.75, r
    assert r["post_train_identity_miou_grouped"] > 0.25, r
    assert r["background_iou"] > 0.8, r
    assert 5 <= r["n_tracks"] <= 120, r
    assert r["lerf"]["lerf_mask_iou"] > 0.10, r
    assert r["lerf"]["lerf_boundary_iou"] > 0.05, r
    assert r["lerf"]["control_export_px_frac"] < 0.01, r
    assert os.path.exists(tmp_path / "merge_debug.npz")
