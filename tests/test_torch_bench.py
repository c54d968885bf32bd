"""The port's measurement entry points (``segsplat_tpu_torch.bench`` and the
four stage scoreboards ``perf_raster_stages``, ``perf_bin_dissect``,
``perf_lift_stages``, ``perf_train``) against the repo's bench.py and
scripts/perf_*.py on the CPU, at small sizes and on two torch threads.

Tolerances: the seeded scenes bit for bit; the headline frame's argmax sum
and the hostile frames' largest pair count and overflow exactly (K1's plain
version against the JAX ``rasterize(backend="pallas")`` in interpret mode and
the JAX binning); the dissected binning's projection at rtol/atol 1e-5 (as
tests/test_torch_rasterize.py holds it), its depth order, sorted fields'
radii and validity, sorted keys, ranks and offsets exactly when fed JAX's
projection (its means at 1e-5); the blend alone on the scoreboard's inputs
against ``rasterize``'s image at 1e-4 (the blend's tolerance); the lift's
full view against JAX ``lift_view_splat``: counts exactly, sums at rtol/atol
1e-5 (tests/test_torch_lift_splat.py's); the resize lines against each other
at 1e-6 (the same bilinear weights in another memory order)."""

import ast
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import (LIFT_ORIGIN, LIFT_VS, lift_camera, lift_occupancy, occupied_voxels,
                         torch_threads)
from segsplat_tpu.core.types import Camera as JCamera
from segsplat_tpu.ops import lift_splat as JLS
from segsplat_tpu.ops import rasterize as JR
from segsplat_tpu_torch import (bench, perf_bin_dissect, perf_lift_stages, perf_raster_stages,
                                perf_train)
from segsplat_tpu_torch.ops import rasterize as PR
from segsplat_tpu_torch.ops.blend import blend_tiles_plain

REPO = os.path.join(os.path.dirname(__file__), "..")
W, H, N = 64, 48, 2000
RENDER_ARRAYS = ("xyz", "scales", "quats", "opac", "logits")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    with torch_threads(2):
        yield


def _by_path(name: str, rel: str):
    """A pre-port file of the repo loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    return _by_path("jax_bench", "bench.py")


def _jax_frame_args(W_, H_, yaw=0.0):
    """bench.py's camera turned by ``yaw``: (viewmat, fx, fy, cx, cy), the
    intrinsics the port's float32 values. XLA's float32 tan and torch's part
    by an ulp (fy 60.971493 against 60.971497 at 48 rows), held here at rtol
    1e-6; the frames are compared on the same intrinsics."""
    Rm = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                  np.float32)
    cam = JCamera(R=jnp.asarray(Rm), T=jnp.zeros(3), fov_x=jnp.asarray(1.2),
                  fov_y=jnp.asarray(0.75), width=W_, height=H_)
    K = np.asarray(cam.intrinsics())
    intr = perf_raster_stages.bench_intrinsics(W_, H_)
    np.testing.assert_allclose(intr, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], rtol=1e-6)
    return (cam.world_view_transform(), *(jnp.float32(x) for x in intr))


# ─────────────────────────────── (a) the scenes ───────────────────────────────

@pytest.mark.parametrize("name", ["headline_render_scene", "hostile_render_scene"])
def test_render_scenes_match_bench_py(jbench, name):
    want, got = getattr(jbench, name)(W, H, N), getattr(bench, name)(W, H, N)
    for k in RENDER_ARRAYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    assert want["kw"].pop("backend") == "pallas" and got["kw"].pop("backend") == "cuda"
    assert got["kw"] == want["kw"] and (got["W"], got["H"]) == (want["W"], want["H"])
    # the defaults are bench.py's 1080p and 200 000 Gaussians
    assert bench.headline_render_scene.__defaults__ == jbench.headline_render_scene.__defaults__


def test_make_scene_matches_perf_raster_stages():
    jax_script = _by_path("jax_perf_raster_stages", "scripts/perf_raster_stages.py")
    for got, want in zip(perf_raster_stages.make_scene(N), jax_script.make_scene(N)):
        np.testing.assert_array_equal(got, np.asarray(want))
    headline = bench.headline_render_scene(N=N)
    for got, k in zip(perf_raster_stages.make_scene(N), RENDER_ARRAYS):
        np.testing.assert_array_equal(got, headline[k], err_msg=k)


def test_lift_scene_matches_bench_py(jbench):
    """One view at full size: 109 000 voxels, [1, 512, 292, 438] fp16 maps."""
    want = jbench.officescene_lift_scene(n_views=1)
    got = bench.officescene_lift_scene(n_views=1)
    for k in ("W", "H", "C", "vs"):
        assert got[k] == want[k], k
    for k in ("centers", "ids", "feats", "intr", "c2ws"):
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_lift_scene_draws_views_as_one_draw():
    """The maps drawn view by view are the bits of bench.py's one draw of
    every view (a small size, so that the one draw stays small)."""
    size, views = (64, 48, 8, 500), 3
    got = bench.officescene_lift_scene(views, size)
    rng = np.random.default_rng(1)
    rng.choice(60 * 44 * 42, size=500, replace=False)
    want = rng.random((views, 8, 24, 32)).astype(np.float16)
    np.testing.assert_array_equal(got["feats"], want)


# ───────────────────────────── (b), (c) the bench ─────────────────────────────

def test_headline_frame_matches_jax_pallas(jbench):
    sc = bench.headline_render_scene(W, H, N)
    jsc = jbench.headline_render_scene(W, H, N)
    vm, fx, fy, cx, cy = _jax_frame_args(W, H)
    with pltpu.force_tpu_interpret_mode():
        out = JR.rasterize(*(jsc[k] for k in RENDER_ARRAYS), vm, fx, fy, cx, cy,
                           bg=jnp.zeros(32, jnp.float32), **jsc["kw"])
    want = int(jnp.sum(jnp.argmax(out["image"], axis=-1).astype(jnp.int32)))
    t = bench.scene_tensors(sc, "cpu")
    got = bench.frame(t, perf_raster_stages.vm_of(0.0, W, H), perf_raster_stages.bench_intrinsics(
        W, H), torch.zeros(32), sc["kw"]).tolist()
    assert got == [want, int(out["num_pairs"]), int(out["tile_overflow"])]
    assert int(out["num_pairs"]) > 1000 and 0 < want


def test_hostile_pairs_and_overflow_match_jax(jbench):
    """The largest pair count and overflow over two timed sets of two frames
    each (yaws 0.003 apart), folded on the device, against JAX's binning of
    the same cameras."""
    frames, sets = 2, 2
    got = bench.bench_hostile_render("cpu", W, H, N, frames, sets)
    jsc = jbench.hostile_render_scene(W, H, N)
    kw = jsc["kw"]
    pairs, over = [], []
    for i in range(frames * sets):
        vm, fx, fy, cx, cy = _jax_frame_args(W, H, 0.003 * i)
        proj = JR.project_gaussians(jsc["xyz"], jsc["scales"], jsc["quats"], vm, fx, fy, cx, cy,
                                    W, H)
        _, _, off, _ = JR._bin_gaussian_ranks(proj, W, H, kw["max_tiles_per_axis"])
        off = np.asarray(off)
        pairs.append(int(off[-1]))
        over.append(int(np.maximum(np.diff(off) - kw["max_per_tile"], 0).sum()))
    assert got["max_pairs_per_frame"] == max(pairs) > 0
    assert got["tile_overflow_max"] == max(over) > 0
    assert got["fps"] > 0 and got["config"].endswith("m=6 K=512")


def _bench_py_keys(jbench_path: str) -> set:
    """Every key that bench.py's main and bench_hostile_render write into its
    line: dict-literal keys and ``extra[...] =`` assignments."""
    tree = ast.parse(open(jbench_path).read())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("main", "bench_hostile_render"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    keys.update(k.value for k in node.keys if isinstance(k, ast.Constant))
                elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
                    keys.add(node.slice.value)
    return keys


def _line_keys(obj) -> set:
    keys = set()
    for k, v in obj.items():
        keys.add(k)
        if isinstance(v, dict):
            keys |= _line_keys(v)
    return keys


def test_bench_main_prints_bench_py_keys(capsys):
    line = bench.main(device="cpu", width=W, height=H, n=N, frames=2, sets=1, hostile_frames=2,
                      lift_views=2, lift_reps=1, lift_size=(W, H, 8, N))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    want = _bench_py_keys(os.path.join(REPO, "bench.py"))
    assert _line_keys(line) == want - {"lift_vs_baseline", "lift_baseline_views_per_s"}
    assert line["metric"] == "semantic_render_fps_1080p_200k" and line["unit"] == "fps"
    assert line["vs_baseline"] == round(line["value"] / 30.0, 3)
    assert line["extra"]["lift_views_per_s"] > 0
    assert set(line["extra"]["hostile_render"]) == {"fps", "config", "max_pairs_per_frame",
                                                    "tile_overflow_max"}


# ─────────────────────────────── (d) the binning ──────────────────────────────

def test_bin_dissect_matches_jax():
    xyz, scales, quats = perf_raster_stages.make_scene(N)[:3]
    vm, fx, fy, cx, cy = _jax_frame_args(W, H, 0.002)
    jproj = JR.project_gaussians(jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(quats), vm,
                                 fx, fy, cx, cy, W, H)
    pproj = PR.project_gaussians(*map(torch.from_numpy, (xyz, scales, quats)),
                                 perf_raster_stages.vm_of(0.002, W, H),
                                 *perf_raster_stages.bench_intrinsics(W, H), W, H)
    got0 = perf_bin_dissect.upto(0, pproj, W, H, 3)["proj"]
    for name in ("means2d", "depths", "conics", "radii"):
        np.testing.assert_allclose(getattr(got0, name).numpy(), np.asarray(getattr(jproj, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got0.valid.numpy(), np.asarray(jproj.valid))

    # the later stages on JAX's projection, so that a ceil(3σ) radius cannot round apart
    out = perf_bin_dissect.upto(7, PR.Projected(*(torch.from_numpy(np.array(x)) for x in jproj)),
                                W, H, 3)
    j_order, j_ranks, j_off, _ = JR._bin_gaussian_ranks(jproj, W, H, 3)
    np.testing.assert_array_equal(out["order"].numpy(), np.asarray(j_order))
    for name in ("means2d", "radii", "valid"):
        want = np.asarray(getattr(jproj, name))[np.asarray(j_order)]
        np.testing.assert_allclose(out[name].numpy(), want, rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out["rank_sorted"].numpy(), np.asarray(j_ranks))
    np.testing.assert_array_equal(out["offsets"].numpy(), np.asarray(j_off))
    # the sorted keys: tile << rank_bits | rank, the tile of each sorted pair
    # read off JAX's offsets (the sentinel tile T past its last run)
    off = np.asarray(j_off)
    tiles = np.searchsorted(off, np.arange(out["skey"].numel()), side="right") - 1
    rank_bits = int(np.ceil(np.log2(N)))
    np.testing.assert_array_equal(out["skey"].numpy(), (tiles << rank_bits) | np.asarray(j_ranks))
    assert int(off[-1]) > 1000
    # every stage's checksum runs, and the stages nest
    sums = [float(perf_bin_dissect.checksum(perf_bin_dissect.upto(s, pproj, W, H, 3)))
            for s in range(len(perf_bin_dissect.STAGES))]
    assert all(np.isfinite(sums)) and len(set(sums)) > 1


# ─────────────────────────────── (e) the blend alone ──────────────────────────

def test_blend_alone_inputs_give_rasterize_image():
    t = {k: torch.from_numpy(v) for k, v in zip(RENDER_ARRAYS, perf_raster_stages.make_scene(N))}
    cam = perf_raster_stages.bench_intrinsics(W, H)
    vms = [perf_raster_stages.vm_of(0.002 * i, W, H) for i in range(2)]
    bg = torch.zeros(32)
    for vm, bi in zip(vms, perf_raster_stages.blend_alone_inputs(t, vms, cam, W, H, 3, 256)):
        img, alpha = blend_tiles_plain(bi.offsets, bi.sorted_payload, bg, bi.tx_n, bi.ty_n, 256)
        ref = PR.rasterize(*(t[k] for k in RENDER_ARRAYS), vm, *cam, W, H, bg=bg,
                           max_tiles_per_axis=3, max_per_tile=256)
        np.testing.assert_allclose(img[:H, :W].numpy(), ref["image"].numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(alpha[:H, :W].numpy(), ref["alpha"].numpy(), rtol=1e-4,
                                   atol=1e-4)
        assert float(ref["alpha"].max()) > 0.5


def test_timeit_folds_each_set_and_takes_the_least():
    calls = []
    ms, outs = perf_raster_stages.timeit(None, lambda x: calls.append(x) or torch.tensor(x),
                                         [[1, 2], [3, 4], [5, 6]], "cpu", combine=torch.maximum)
    assert calls == [1, 2, 1, 2, 3, 4, 5, 6]        # one untimed pass over the first set
    assert [int(o) for o in outs] == [2, 4, 6] and ms >= 0


# ─────────────────────────────── (f) the lift ─────────────────────────────────

def _small_lift_scene(channels=24):
    """tests/test_lift_splat.py's grid and view 1 of 3 at 48×40, with a
    seeded half-resolution fp16 map, as a lift scene dict."""
    centers, ids = occupied_voxels(lift_occupancy(np.random.default_rng(0)), LIFT_VS,
                                   LIFT_ORIGIN)
    Wl, Hl = 48, 40
    feats = np.random.default_rng(3).random((1, channels, Hl // 2, Wl // 2)).astype(np.float16)
    return dict(W=Wl, H=Hl, C=channels, vs=LIFT_VS, centers=centers, ids=ids, feats=feats,
                intr=np.array([[45.0, 45.0, Wl / 2, Hl / 2]], np.float32),
                c2ws=lift_camera(1, 3)[None])


def test_lift_full_view_matches_jax_lift_view_splat():
    import jax

    sc = _small_lift_scene()
    st = bench.lift_tensors(sc, "cpu")
    sums, counts, _ = bench.lift_view(st, 0)
    fmap = jax.image.resize(jnp.asarray(sc["feats"][0]).astype(jnp.float32),
                            (sc["C"], sc["H"], sc["W"]), method="bilinear")
    j_sums, j_counts, _ = JLS.lift_view_splat(
        jnp.asarray(sc["centers"]), jnp.asarray(sc["ids"]), jnp.asarray(sc["c2ws"][0]),
        jnp.asarray(sc["intr"][0]), jnp.asarray(LIFT_VS, jnp.float32), 0.01, 10.0,
        jnp.asarray(LIFT_VS * 0.5, jnp.float32), jnp.transpose(fmap, (1, 2, 0)),
        len(sc["centers"]) + 1, sc["W"], sc["H"], max_tiles_per_axis=8, max_per_tile=128)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-5, atol=1e-5)
    assert int(counts.sum()) > 0.3 * sc["W"] * sc["H"]
    # the splat line alone and the resize lines: the same hits and maps
    hits = perf_lift_stages.first_hit(st, 0)
    assert int((hits > 0).sum()) == int(counts.sum())
    chw = perf_lift_stages.resize_chw(st, 0)
    np.testing.assert_allclose(chw.numpy(), np.asarray(fmap), rtol=1e-5, atol=1e-5)
    for hwc in (perf_lift_stages.resize_hwc(st, 0), perf_lift_stages.transpose_then_resize(st, 0)):
        np.testing.assert_allclose(hwc.numpy(), chw.permute(1, 2, 0).numpy(), rtol=1e-6,
                                   atol=1e-6)


# ─────────────────────────────── (g) the train step ───────────────────────────

def test_perf_train_scene_matches_script(monkeypatch):
    """The JAX script's draws, caught as it makes them: it runs up to its
    first traced step, which raises."""
    import segsplat_tpu.train.trainer as JT

    script = _by_path("jax_perf_train", "scripts/perf_train.py")
    seen, arrays = {}, []

    class Stop(Exception):
        pass

    def table(pts, cols, cap, max_sh_degree):
        seen.update(pts=pts, cols=cols, cap=cap, sh=max_sh_degree)

    def step_maker(cfg, opts, raster_kw):
        seen.update(classes=cfg.num_classes, raster_kw=raster_kw)

        def step(*a):
            raise Stop
        return step

    monkeypatch.setattr(JT, "init_table_from_pcd", table)
    monkeypatch.setattr(JT, "make_optimizer", lambda *a, **k: None)
    monkeypatch.setattr(JT, "init_state", lambda *a, **k: (None, None))
    monkeypatch.setattr(JT, "make_train_step", step_maker)
    real_jnp = script.jnp

    class RecordingJnp:
        def __getattr__(self, name):
            return getattr(real_jnp, name)

        def asarray(self, x, *a, **k):
            if isinstance(x, np.ndarray) and x.ndim >= 2:
                arrays.append(x)
            return real_jnp.asarray(x, *a, **k)

    monkeypatch.setattr(script, "jnp", RecordingJnp())
    with pytest.raises(Stop):
        script.main()
    pts, cols, gt, gto = perf_train.train_scene()
    np.testing.assert_array_equal(pts, seen["pts"])
    np.testing.assert_array_equal(cols, seen["cols"])
    big = [a for a in arrays if a.shape[-2:] == gt.shape[-2:]]
    np.testing.assert_array_equal(gt, big[0])
    np.testing.assert_array_equal(gto, big[1])
    assert (seen["cap"], seen["sh"], seen["classes"]) == (perf_train.CAPACITY, 3, 256)
    kw = dict(seen["raster_kw"], backend="cuda")
    assert kw == perf_train.RASTER_KW


def test_perf_train_step_runs_on_cpu(capsys):
    out = perf_train.main(device="cpu", size=(64, 48), capacity=768, n=600, f1=1, f2=0, reps=1)
    assert out["steps"] == 2 and len(out["step_ms"]) == 1 and out["ms_per_step"] > 0
    assert "ms/step" in capsys.readouterr().out


def test_twins_refuse_the_cpu_fallback(capsys):
    """Asked for the card where there is none, each twin raises (the bench
    prints bench.py's error line and exits 1); none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the twins would run on it")
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["value"] == 0.0 and "error" in line["extra"]
    for mod in (perf_raster_stages, perf_bin_dissect, perf_lift_stages, perf_train):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
