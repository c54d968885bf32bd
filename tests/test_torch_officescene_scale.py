"""The production-run twin (``python -m segsplat_tpu_torch.officescene_scale_run``)
on the CPU at a tiny scene, against the JAX script scripts/officescene_scale_run.py
loaded by path.

The tiny dimensions: 20 000 Gaussians (the JAX ``--smoke`` count; at 2 000 the
density filter keeps 11 points), 4 views, a 110×73 render (220×146 native, fx
176) and 16×24 feature maps of 16 channels. Tolerances: the fabricated files
byte for byte; the grid PLY byte for byte; the lift's counts equal and sums at
rtol/atol 1e-5 (tests/test_torch_lift_features.py's); the 1-NN map equal to
JAX's or within tests/_torch_port.nn_index_mismatch's tie bound; the query's
labels equal. Stage 5 runs K1's plain version once a view."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from segsplat_tpu_torch import officescene_scale_run as O
from segsplat_tpu_torch import run_pipeline
from segsplat_tpu_torch.io.artifacts import load_label_map, load_voxel_features
from segsplat_tpu_torch.ops import blend as B
from tests._torch_port import nn_index_mismatch, torch_threads

REPO = os.path.join(os.path.dirname(__file__), "..")
TINY = O.SceneDims(gaussians=20_000, views=4, native_w=220, native_h=146, render_w=110,
                   render_h=73, feat_h=16, feat_w=24, channels=16, fx_native=176.0)
JAX_GLOBALS = dict(N_GAUSS="gaussians", N_VIEWS="views", NATIVE_W="native_w",
                   NATIVE_H="native_h", REND_W="render_w", REND_H="render_h",
                   FEAT_H="feat_h", FEAT_W="feat_w", C="channels", FX_NATIVE="fx_native")


def _jax_script():
    """scripts/officescene_scale_run.py as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_officescene_scale_run", os.path.join(REPO, "scripts", "officescene_scale_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    """{relative path: ("link", target) or ("file", bytes)} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.readlink(p))
            else:
                with open(p, "rb") as f:
                    out[rel] = ("file", f.read())
    return out


def test_fabricate_writes_the_jax_scripts_bytes(tmp_path, monkeypatch):
    """Both fabricate at TINY into the same path in turn (cfg_args and the
    symlinks name it): every file, PLY, COLMAP binaries, cfg_args, camera JSON,
    PNGs, the fp16 map and its symlinks, the same bytes."""
    jax_mod = _jax_script()
    for name, field in JAX_GLOBALS.items():
        monkeypatch.setattr(jax_mod, name, getattr(TINY, field))
    work = str(tmp_path / "work")
    got_jax = jax_mod.fabricate(work, np.random.default_rng(0))
    jax_tree = _tree(work)
    os.rename(work, str(tmp_path / "jax"))
    got = O.fabricate(work, np.random.default_rng(0), TINY)
    assert got == got_jax
    tree = _tree(work)
    assert sorted(tree) == sorted(jax_tree)
    assert len(tree) == 6 + 2 * TINY.views     # PLY, cfg_args, JSON, three .bin
    for rel in tree:
        assert tree[rel] == jax_tree[rel], rel
    assert sum(kind == "link" for kind, _ in tree.values()) == TINY.views - 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The twin at TINY on the CPU (4 views lifted, 4 rendered), then the JAX
    run_pipeline with the JAX script's arguments and --skip_render on the
    twin's fabricated scene, its LiftConfig given the port's per-tile K (256
    by default, the JAX package's 128). The lift's returns of both are kept."""
    import functools

    import run_pipeline as jax_run_pipeline
    import segsplat_tpu.pipeline.lift_features as jax_lift

    from segsplat_tpu_torch.pipeline.lift_features import LiftConfig

    root = tmp_path_factory.mktemp("officescene")
    lifts, plain_calls = {}, []

    def keep(key, fn):
        def call(*a, **k):
            lifts[key] = fn(*a, **k)
            return lifts[key]
        return call

    def counted(*a, **k):
        plain_calls.append(a[0].device.type)
        return plain(*a, **k)

    plain = B.blend_tiles_plain
    work = str(root / "port")
    with pytest.MonkeyPatch.context() as mp, torch_threads(2):
        mp.setattr(run_pipeline, "aggregate_voxel_features",
                   keep("port", run_pipeline.aggregate_voxel_features))
        mp.setattr(jax_lift, "aggregate_voxel_features",
                   keep("jax", jax_lift.aggregate_voxel_features))
        mp.setattr(jax_lift, "LiftConfig", functools.partial(
            jax_lift.LiftConfig, splat_max_per_tile=LiftConfig().splat_max_per_tile))
        mp.setattr(B, "blend_tiles_plain", counted)
        port = O.run(work, TINY, lift_views=4, render_views=4, device="cpu")
        jax_work = str(root / "jax")
        jax_run_pipeline.main(
            ["-s", os.path.join(work, "scene"), "-m", os.path.join(work, "model"),
             "--iteration", "30000", "--lseg_dir", os.path.join(work, "lseg_features"),
             "--camera_params", os.path.join(work, "camera_params.json"),
             "--prompt", *O.PROMPTS, "--cell_size", "0.04", "--opacity_threshold", "0.2",
             "--view_chunk", "4", "--max_views", "4", "--render_views", "4",
             "--work_dir", jax_work, "--skip_render"])
    return dict(port=port, work=work, jax_work=jax_work, lifts=lifts, plain_calls=plain_calls)


def test_pipeline_matches_jax(runs):
    """Stages 1–4 of the twin against the JAX pipeline on the same scene."""
    port, jax_work = runs["port"], runs["jax_work"]
    assert list(port["timing"]) == ["fabricate", "voxel_grid", "lift", "centers_map", "query",
                                    "render"]
    grid = port["grid_ply"]
    jgrid = os.path.join(jax_work, os.path.basename(grid))
    with open(grid, "rb") as a, open(jgrid, "rb") as b:
        assert a.read() == b.read()

    got, ref = runs["lifts"]["port"], runs["lifts"]["jax"]
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(ref["counts"]))
    assert int((got["counts"][1:] > 0).sum()) > 1000
    np.testing.assert_allclose(got["sums"].numpy(), np.asarray(ref["sums"]), rtol=1e-5,
                               atol=1e-5)
    assert os.path.basename(got["artifact"]) == os.path.basename(ref["artifact"])

    work = port["work_dir"]
    mu = np.load(os.path.join(work, "gaussian_mu.npy"))
    np.testing.assert_array_equal(mu, np.load(os.path.join(jax_work, "gaussian_mu.npy")))
    g2v = np.load(os.path.join(work, "gauss2voxel.npy"))
    nn_index_mismatch(mu, load_voxel_features(port["voxel_features"])["pos"], g2v,
                      np.load(os.path.join(jax_work, "gauss2voxel.npy")))

    labels = np.load(port["semantics"])["labels"]
    np.testing.assert_array_equal(
        labels, np.load(os.path.join(jax_work, "gaussian_semantics.npz"))["labels"])
    assert len(np.unique(labels)) > 1


def test_stage5_runs_the_plain_k1_once_a_view(runs):
    """Stage 5 on the CPU: K1's plain version once a view; each label map is
    the argmax of its written fp16 logits wherever their top two differ."""
    assert runs["plain_calls"] == ["cpu"] * 4
    out_dir = os.path.join(runs["work"], "model", "train", "ours_30000", "semantics")
    for i in range(4):
        lab = load_label_map(os.path.join(out_dir, f"{i:05d}_labels.pt"))
        logits = np.load(os.path.join(out_dir, f"{i:05d}_logits.npy"))
        assert lab.shape == (TINY.render_h, TINY.render_w)
        assert logits.shape == (len(O.PROMPTS), TINY.render_h, TINY.render_w)
        assert logits.dtype == np.float16 and np.isfinite(logits).all()
        top2 = np.sort(logits, axis=0)[-2:]
        clear = top2[1] > top2[0]
        empty = (logits == 0).all(0)            # no Gaussian covers the pixel: bg 0
        assert clear.sum() > 500 and not (clear & empty).any()
        np.testing.assert_array_equal(lab[clear], logits.argmax(0)[clear])
        np.testing.assert_array_equal(lab[empty], 0)


def test_main_flags(monkeypatch, tmp_path):
    """main's flags: FULL, 16 lift views and 216 rendered by default, the work
    dir in the temporary directory; --smoke selects SMOKE and caps the lift at
    4 views in run."""
    calls = []
    monkeypatch.setattr(O, "run", lambda *a: calls.append(a))
    monkeypatch.setattr(O.tempfile, "gettempdir", lambda: str(tmp_path))
    O.main([])
    O.main(["--smoke", "--device", "cpu", "--lift_views", "9", "--skip_render"])
    assert calls == [(str(tmp_path / "officescene_scale"), O.FULL, 16, 216, False, "cuda"),
                     (str(tmp_path / "officescene_smoke"), O.SMOKE, 9, 216, True, "cpu")]
    assert O.SMOKE.max_lift_views == 4 and O.FULL.max_lift_views is None


def test_no_card_no_run(tmp_path):
    """--device cuda (the default) raises without a card, before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device runs")
    work = tmp_path / "work"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        O.main(["--work", str(work), "--device", "cuda"])
    assert not work.exists()
