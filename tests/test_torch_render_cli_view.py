"""Stage 5's per-view products step
(segsplat_tpu_torch/pipeline/render_semantics.semantic_view_products) on the
CPU: 500 seeded Gaussians with 13 logits, five 64×48 views at view_batch 2
(the last batch partial), m = 6, K = 256. The products hold against the
benchmark's plain reference (benchmark/reference/render.py);
render_semantic_views writes them through write_view_artifacts; an explicit
pair cap truncates, warns and counts its drops, the default takes none; the
spans come one a view and one a batch."""

import math
import os

import numpy as np
import pytest
import torch

from benchmark.reference import raster
from benchmark.reference import render as reference
from segsplat_tpu_torch.core.types import Camera, GaussianTable
from segsplat_tpu_torch.io.artifacts import load_label_map
from segsplat_tpu_torch.pipeline.render_semantics import (render_semantic_views,
                                                          semantic_view_products)
from segsplat_tpu_torch.utils import profiling
from tests._torch_port import F, H, W, scene, torch_threads

P, N_VIEWS, BATCH, M, K = 13, 5, 2, 6, 256
FOV_X, FOV_Y = 2 * math.atan(W / (2 * F)), 2 * math.atan(H / (2 * F))


def _yaw(a: float) -> torch.Tensor:
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@pytest.fixture(scope="module")
def room():
    """The table, its logits [N, 13] and five cameras turning about y."""
    sc = scene(11, n=500, log_scale=-2.0, ch=P)
    n = len(sc["xyz"])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    op = t(sc["opac"])
    table = GaussianTable(
        xyz=t(sc["xyz"]), features_dc=torch.zeros(n, 1, 3), features_rest=torch.zeros(n, 1, 3),
        scaling=torch.log(t(sc["scales"])), rotation=t(sc["quats"]),
        opacity=torch.log(op / (1 - op))[:, None], objects_dc=torch.zeros(n, 1, 16),
        active=torch.ones(n, dtype=torch.bool), active_sh_degree=0)
    cams = [Camera(R=_yaw(0.05 * (v - 2)), T=torch.tensor([0.0, 0.0, 0.1 * v]),
                   fov_x=torch.tensor(FOV_X), fov_y=torch.tensor(FOV_Y), width=W, height=H)
            for v in range(N_VIEWS)]
    return table, t(sc["colors"]), cams


def _products(room, **kw):
    table, logits, cams = room
    with torch_threads(2):
        return list(semantic_view_products(table, cams, logits, max_tiles_per_axis=M,
                                           max_per_tile=K, view_batch=BATCH, **kw))


def test_the_products_hold_against_the_plain_reference(room):
    table, logits, cams = room
    recs = _products(room)
    assert [r.index for r in recs] == list(range(N_VIEWS))
    assert any(r.tile_overflow for r in recs)              # K binds, on both sides
    g = reference.gaussians(table.xyz, table.scaling, table.rotation, table.opacity)
    for rec, cam in zip(recs, cams):
        assert rec.labels.dtype == np.int32 and rec.labels.shape == (H, W)
        assert rec.logits.dtype == np.float16 and rec.logits.shape == (P, H, W)
        assert rec.confidence.dtype == np.float32 and rec.confidence.shape == (H, W)
        assert rec.num_pairs > 0
        with torch_threads(2):
            ref = reference.view_logits(g, logits, raster.pinhole(
                cam.R, cam.T, FOV_X, FOV_Y, W, H), M, K)
        r = ref.numpy()
        assert np.abs(r).max() > 1.0
        assert np.all(np.abs(rec.logits.astype(np.float32) - r) <= 2.0 ** -10 * np.abs(r) + 1e-4)
        top2 = np.sort(r, axis=0)[-2:]
        clear = (top2[1] - top2[0]) > 1e-4
        assert clear.mean() > 0.5
        np.testing.assert_array_equal(rec.labels[clear], reference.labels(ref).numpy()[clear])
        np.testing.assert_allclose(rec.confidence, reference.confidence(ref).numpy(),
                                   rtol=0, atol=1e-6)


def test_render_semantic_views_writes_the_products(room, tmp_path):
    table, logits, cams = room
    with torch_threads(2):
        labels = render_semantic_views(table, cams, logits.numpy(), str(tmp_path),
                                       prompts=[f"p{i}" for i in range(P)], view_batch=BATCH)
    recs = _products(room)
    assert len(labels) == len(recs) == N_VIEWS
    for lab, rec in zip(labels, recs):
        name = f"{rec.index:05d}"
        np.testing.assert_array_equal(lab, rec.labels)
        np.testing.assert_array_equal(load_label_map(str(tmp_path / f"{name}_labels.pt")),
                                      rec.labels)
        saved = np.load(tmp_path / f"{name}_logits.npy")
        assert saved.dtype == np.float16 and np.array_equal(saved, rec.logits)
        for suffix in ("_mask_color.png", "_confidence.png", "_legend.png"):
            assert os.path.getsize(tmp_path / f"{name}{suffix}") > 0


@pytest.mark.parametrize("cap_share", [None, 0.5])
def test_an_explicit_pair_cap_truncates_warns_and_counts(room, tmp_path, capsys, cap_share):
    table, logits, cams = room
    full = _products(room)
    cap = None if cap_share is None else int(cap_share * min(r.num_pairs for r in full))
    profiling.enable()
    profiling.reset()
    try:
        recs = _products(room, pair_cap=cap)
        with torch_threads(2):
            render_semantic_views(table, cams, logits.numpy(), str(tmp_path), pair_cap=cap,
                                  view_batch=BATCH)
    finally:
        profiling.disable()
    views = [r for r in profiling.records() if r.name == "render_cli.view"][:N_VIEWS]
    profiling.reset()
    out = capsys.readouterr().out
    assert [v.counts["pairs"] for v in views] == [r.num_pairs for r in full]
    if cap is None:
        assert [v.counts["dropped"] for v in views] == [0] * N_VIEWS
        assert "pair_cap" not in out
        for a, b in zip(recs, full):
            assert np.array_equal(a.logits, b.logits)
    else:
        assert [v.counts["dropped"] for v in views] == [r.num_pairs - cap for r in full]
        assert out.count(f"> pair_cap {cap}") == N_VIEWS
        # the deepest runs of the highest tile ids are gone: the image's last
        # rows lose what covered them
        assert all(not np.array_equal(a.logits, b.logits) for a, b in zip(recs, full))


def test_a_view_records_its_spans_once_and_a_batch_once(room):
    profiling.enable()
    profiling.reset()
    try:
        _products(room)
    finally:
        profiling.disable()
    recs = profiling.records()
    profiling.reset()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert len(by["render_cli.view"]) == N_VIEWS
    assert len(by["render_cli.batch"]) == -(-N_VIEWS // BATCH)
    for name in ("render_cli.fetch", "render_cli.labels", "render_cli.confidence"):
        assert len(by[name]) == N_VIEWS and {r.parent for r in by[name]} == {"render_cli.view"}
    assert {r.parent for r in by["render_cli.batch"]} == {"render_cli.view"}
    assert {r.parent for r in by["raster.bin"]} == {"render_cli.batch"}
    assert len(by["raster.bin"]) == N_VIEWS and "render_cli.write" not in by
