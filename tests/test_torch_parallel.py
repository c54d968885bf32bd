"""The port's parallel programs (segsplat_tpu_torch/parallel/) against the JAX
package's and against themselves at world 1, on the CPU. Several ranks run as
gloo processes of this file (``python tests/test_torch_parallel.py worker
MODE ...``, launched by ``_torch_port.run_ranks``), which meet at a
``file://`` rendezvous under the test's tmp_path and fail on a timeout.

  * ``lift_views_sharded`` at view 2 × tensor 2 against JAX ``lift_views_scan``
    on tests/test_parallel.py's scene (counts exact, sums rtol/atol 1e-5),
    also with 3 views (a rank lifts 1) and 1 view (a rank lifts none);
  * ``rasterize_sharded`` at 4 strips against JAX ``rasterize`` on that
    file's 64×64 scene at 1e-5, on both backends; and strips that are the
    port's frame bit for bit where the tile cap truncates wide Gaussians,
    where the JAX strips part from the JAX frame;
  * the B = 2 step at world 1 against JAX ``make_parallel_train_step`` on a
    1×1 mesh, run in a subprocess as tests/_parallel_step_worker.py does, with
    JAX's contrastive draws fed: metrics 1e-4, the densify statistics and the
    parameters at tests/test_torch_train_step.py's tolerances;
  * the B = 4 step at world 2 (view) and 2×2 (view × tensor) against world 1:
    metrics rtol 1e-3 / atol 1e-5, parameters and codebook rtol 1e-4 / atol
    1e-5 (the tolerances of the JAX dryrun and tests/test_parallel_cli.py);
    then a densify step and a second step, after which every rank's
    parameters are the same bits;
  * ``stack_cameras`` and the strip-height ValueError.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import (H, PARALLEL_STEP, W, port_train_setup, run_ranks, scene,
                         worker_main)

HERE = os.path.abspath(__file__)
STEP_RASTER = dict(max_tiles_per_axis=4, max_per_tile=128)
METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5


# ───────────────────────────── inputs (numpy, seeded) ─────────────────────────────

def lift_inputs() -> dict:
    """tests/test_parallel.py's lift scene: 8 inward cameras of 32×24 around an
    occupied 4³ block of an 8³ grid, 16 channels (its ``rng`` fixture's draws)."""
    rng = np.random.default_rng(0)
    V, h, w, C = 8, 24, 32, 16
    feats = rng.random((V, h, w, C)).astype(np.float32)
    c2ws, intr = [], []
    for i in range(V):
        ang = 2 * np.pi * i / V
        pos = np.array([2.5 * np.sin(ang), 0.0, 2.5 * np.cos(ang) * -1.0])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, pos
        c2ws.append(c2w)
        intr.append([40.0, 40.0, w / 2, h / 2])
    occ = np.zeros((8, 8, 8), np.int32)
    ids = np.arange(1, 1 + 8 ** 3).reshape(8, 8, 8)
    occ[2:6, 2:6, 2:6] = ids[2:6, 2:6, 2:6]
    from segsplat_tpu_torch.ops.lift import default_max_steps

    vs = 0.25
    return dict(feats=feats, c2ws=np.stack(c2ws), intr=np.array(intr, np.float32), occ=occ,
                origin=np.array([-1.0, -1.0, -1.0], np.float32), vs=np.float32(vs),
                inc=np.float32(vs * 0.5), num_ids=int(occ.max()) + 1,
                steps=default_max_steps(w, h, 40.0, 40.0, 0.5, 6.0, vs * 0.5))


LIFT_VIEWS = (8, 3, 1)          # over 2 view ranks: 4 + 4, 2 + 1, 1 + 0


def render_inputs() -> dict:
    """tests/test_parallel.py's strip scene: 400 Gaussians, 8 channels, 64×64."""
    rng = np.random.default_rng(0)
    n = 400
    xyz = rng.random((n, 3)) * np.array([3, 2, 2]) + np.array([-1.5, -1, 1.5])
    scales = np.exp(rng.normal(-2.5, 0.3, (n, 3)))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, (n,))
    colors = rng.random((n, 8))
    bg = rng.random(8)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(xyz=f32(xyz), scales=f32(scales), quats=q, opac=f32(opac),
                colors=f32(colors), bg=f32(bg))


RENDER_ARGS = dict(width=64, height=64, max_tiles_per_axis=4, max_per_tile=128,
                   tile_chunk=4)
RENDER_FOCAL = 60.0
SCENE_KEYS = ("xyz", "scales", "quats", "opac", "colors")


# ───────────────────────────── the ranks' work ─────────────────────────────

def _run_lift(mesh, d: dict, views: int):
    from segsplat_tpu_torch.parallel import lift_views_sharded

    t = lambda k: torch.from_numpy(np.asarray(d[k]))
    return lift_views_sharded(mesh, t("feats")[:views], t("occ"), t("c2ws")[:views],
                              t("intr")[:views], t("origin"), t("vs"), 0.5, 6.0,
                              float(d["inc"]), int(d["num_ids"]), int(d["steps"]))


def _run_strips(mesh, backend: str):
    from segsplat_tpu_torch.parallel import rasterize_sharded

    sc = render_inputs()
    kw = dict(RENDER_ARGS)
    w, h = kw.pop("width"), kw.pop("height")
    return rasterize_sharded(mesh, *(torch.from_numpy(sc[k]) for k in SCENE_KEYS),
                             torch.eye(4), RENDER_FOCAL, RENDER_FOCAL, w / 2, h / 2, w, h,
                             bg=torch.from_numpy(sc["bg"]), backend=backend, **kw)


def _snapshot(state, metrics=None) -> dict:
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    out = {f: getattr(state.table, f).detach().numpy().copy() for f in PARAM_FIELDS}
    out["code_book"] = state.code_book.detach().numpy().copy()
    out["g_code_book"] = state.code_book.grad.numpy().copy()
    out["g_xyz"] = state.table.xyz.grad.numpy().copy()
    out["active"] = state.table.active.numpy().copy()
    for k, v in zip(("grad_accum", "denom", "max_radii"), state.stats):
        out[k] = v.numpy().copy()
    for k, v in (metrics or {}).items():
        out["m_" + k] = np.asarray(float(v))
    return out


def _train_two_steps(mesh) -> tuple:
    """Step 1 of the B = 4 batch, a densify step, then step 2: (after step 1,
    after step 2) snapshots. Every rank draws from the same generator."""
    from segsplat_tpu_torch.core.types import stack_cameras
    from segsplat_tpu_torch.parallel import make_parallel_train_step
    from segsplat_tpu_torch.parallel.train import replicate_state
    from segsplat_tpu_torch.train.densify import densify_and_prune, zero_adam_rows

    state, cfg, cams, gts, objs = port_train_setup(4)
    replicate_state(state, mesh)
    step = make_parallel_train_step(cfg, mesh, STEP_RASTER)
    gen = torch.Generator().manual_seed(0)
    batch = stack_cameras(cams)
    first = _snapshot(state, step(state, batch, gts, objs, torch.zeros(3), generator=gen))
    table, stats, changed, _ = densify_and_prune(state.table, state.stats, 1e-7, 0.005, 2.0,
                                                 generator=gen)
    zero_adam_rows(state.gauss_opt, changed)
    state.table, state.stats = table, stats
    second = _snapshot(state, step(state, stack_cameras(cams[::-1]), gts[::-1], objs[::-1],
                                   torch.zeros(3), generator=gen))
    return first, second


def _save(workdir, name: str, arrays: dict) -> None:
    np.savez(os.path.join(workdir, name + ".npz"), **arrays)


def world4(rank, world, workdir):
    """view 2 × tensor 2: the lift and the B = 4 step; view 4: the strips."""
    from segsplat_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_view=2, n_tensor=2)
    d = dict(np.load(os.path.join(workdir, "lift.npz")))
    out = {}
    for views in LIFT_VIEWS:
        out[f"sums{views}"], out[f"counts{views}"] = (x.numpy() for x in
                                                      _run_lift(mesh, d, views))
    strips = make_mesh(n_view=4)
    for backend in ("cuda", "dense"):
        r = _run_strips(strips, backend)
        out[f"image_{backend}"], out[f"alpha_{backend}"] = r["image"].numpy(), r["alpha"].numpy()
    _save(workdir, f"world4_rank{rank}", out)
    first, second = _train_two_steps(mesh)
    _save(workdir, f"step22_rank{rank}", first)
    _save(workdir, f"step22_second_rank{rank}", second)


def view2(rank, world, workdir):
    from segsplat_tpu_torch.parallel import make_mesh

    first, second = _train_two_steps(make_mesh(n_view=2))
    _save(workdir, f"step2_rank{rank}", first)
    _save(workdir, f"step2_second_rank{rank}", second)


WORKERS = {"world4": world4, "view2": view2}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two launches, world 4 and world 2, run once for the module."""
    workdir = tmp_path_factory.mktemp("ranks")
    np.savez(workdir / "lift.npz", **lift_inputs())
    run_ranks(HERE, "world4", 4, workdir)
    run_ranks(HERE, "view2", 2, workdir)
    load = lambda name: dict(np.load(workdir / f"{name}.npz"))
    return load


@pytest.fixture(scope="module")
def world1():
    """The B = 4 steps with no process group (the 1×1 mesh)."""
    from segsplat_tpu_torch.parallel import make_mesh

    return _train_two_steps(make_mesh())


# ───────────────────────────── the lift ─────────────────────────────

def test_lift_views_sharded_matches_jax_lift_views_scan(ranks):
    import jax.numpy as jnp

    from segsplat_tpu.ops.lift import lift_views_scan

    d = lift_inputs()
    for views in LIFT_VIEWS:
        ref_s, ref_c = lift_views_scan(
            jnp.asarray(d["feats"][:views]), jnp.asarray(d["occ"]),
            jnp.asarray(d["c2ws"][:views]), jnp.asarray(d["intr"][:views]),
            jnp.asarray(d["origin"]), jnp.asarray(d["vs"]), 0.5, 6.0,
            jnp.asarray(d["inc"]), d["num_ids"], d["steps"], 32, 24)
        assert int(np.asarray(ref_c).sum()) > 0, "the scene must produce hits"
        for rank in range(4):
            got = ranks(f"world4_rank{rank}")
            np.testing.assert_array_equal(got[f"counts{views}"], np.asarray(ref_c))
            np.testing.assert_allclose(got[f"sums{views}"], np.asarray(ref_s), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{views} views, rank {rank}")


def test_lift_views_sharded_on_the_1x1_mesh_is_lift_views_scan():
    from segsplat_tpu_torch.ops.lift import lift_views_scan
    from segsplat_tpu_torch.parallel import make_mesh

    d = lift_inputs()
    t = lambda k: torch.from_numpy(np.asarray(d[k]))
    ref = lift_views_scan(t("feats"), t("occ"), t("c2ws"), t("intr"), t("origin"), t("vs"),
                          0.5, 6.0, t("inc"), d["num_ids"], d["steps"], 32, 24)
    for got, want in zip(_run_lift(make_mesh(), d, 8), ref):
        assert torch.equal(got, want)


# ───────────────────────────── the strips ─────────────────────────────

@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_rasterize_sharded_matches_jax_rasterize(ranks, backend):
    """4 strips on 4 ranks; the kernels' path (their plain versions here)
    against the JAX Pallas blend in interpret mode, the dense one against
    ``"xla"``."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from segsplat_tpu.ops.rasterize import rasterize

    sc = render_inputs()
    kw = dict(RENDER_ARGS)
    w, h = kw.pop("width"), kw.pop("height")
    with pltpu.force_tpu_interpret_mode():
        ref = rasterize(*(jnp.asarray(sc[k]) for k in SCENE_KEYS), jnp.eye(4),
                        RENDER_FOCAL, RENDER_FOCAL, w / 2, h / 2, w, h,
                        bg=jnp.asarray(sc["bg"]),
                        backend="pallas" if backend == "cuda" else "xla", **kw)
    for rank in range(4):
        got = ranks(f"world4_rank{rank}")
        for name in ("image", "alpha"):
            np.testing.assert_allclose(got[f"{name}_{backend}"], np.asarray(ref[name]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{name}, rank {rank}")


def test_strips_keep_the_frames_tile_cap():
    """Wide Gaussians under a per-axis cap of m = 2 tiles: the port's 4 strips,
    rendered in turn, are its whole frame's rows bit for bit, while the JAX
    strips (their m rows counted from each strip's top) part from the JAX
    frame."""
    import jax
    import jax.numpy as jnp

    from segsplat_tpu.ops.rasterize import rasterize as jax_rasterize
    from segsplat_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from segsplat_tpu.parallel.render import rasterize_sharded as jax_rasterize_sharded
    from segsplat_tpu_torch.ops.rasterize import rasterize
    from segsplat_tpu_torch.parallel.render import rasterize_strip

    sc = scene(5, n=300, log_scale=-1.8)
    kw = dict(max_tiles_per_axis=2, max_per_tile=128, tile_chunk=4)
    f, n = RENDER_FOCAL, 64
    args = [torch.from_numpy(sc[k]) for k in SCENE_KEYS] + [torch.eye(4), f, f, n / 2, n / 2]
    bg = torch.from_numpy(sc["bg"])
    for backend in ("cuda", "dense"):
        whole = rasterize(*args, n, n, bg=bg, backend=backend, **kw)
        strips = [rasterize_strip(i, 4, *args, n, n, bg=bg, backend=backend, **kw)
                  for i in range(4)]
        for name in ("image", "alpha"):
            assert torch.equal(torch.cat([s[name] for s in strips]), whole[name]), name
    jargs = [jnp.asarray(sc[k]) for k in SCENE_KEYS] + [jnp.eye(4), f, f, n / 2, n / 2, n, n]
    jwhole = jax_rasterize(*jargs, bg=jnp.asarray(sc["bg"]), **kw)["image"]
    jstrips = jax_rasterize_sharded(jax_make_mesh(4, 1, devices=jax.devices()[:4]), *jargs,
                                    bg=jnp.asarray(sc["bg"]), **kw)["image"]
    assert float(np.abs(np.asarray(jstrips) - np.asarray(jwhole)).max()) > 0.1


def test_strip_height_must_divide_into_tile_aligned_strips():
    from segsplat_tpu_torch.parallel import make_mesh
    from segsplat_tpu_torch.parallel.render import rasterize_strip, strip_height

    assert strip_height(1024, 4) == 256
    for height, n in ((1080, 4), (1080, 1), (64, 8)):
        with pytest.raises(ValueError, match=f"height {height} must divide into {n}"):
            strip_height(height, n)
    sc = render_inputs()
    with pytest.raises(ValueError, match="TILE-aligned"):
        rasterize_strip(0, 2, *(torch.from_numpy(sc[k]) for k in SCENE_KEYS), torch.eye(4),
                        60.0, 60.0, 32.0, 24.0, 64, 48)
    assert make_mesh().shape == {"view": 1, "tensor": 1}


# ───────────────────────────── the train step ─────────────────────────────

def _jax_batch():
    """tests/test_torch_train_step.py's state (Adam moments as after 10⁴
    updates) with two cameras, GT images and mask ids."""
    import jax.numpy as jnp

    from segsplat_tpu.core.types import Camera as JaxCamera
    from test_torch_train_step import _setup

    state, opts, cfg, jcam, pcam, gt, gto = _setup()
    rng = np.random.default_rng(1)
    T2 = np.array([-0.04, 0.03, 0.05], np.float32)
    jcam2 = JaxCamera(R=jcam.R, T=jnp.asarray(T2), fov_x=jcam.fov_x, fov_y=jcam.fov_y,
                      width=W, height=H)
    pcam2 = type(pcam)(R=pcam.R, T=torch.from_numpy(T2), fov_x=pcam.fov_x,
                       fov_y=pcam.fov_y, width=W, height=H)
    gt2 = rng.random((3, H, W)).astype(np.float32)
    gto2 = np.roll(gto, 7, axis=1)
    return state, opts, cfg, [jcam, jcam2], [pcam, pcam2], [gt, gt2], [gto, gto2]


JAX_KEY = 5


def jax_step(out_path):
    """The JAX B = 2 step on a 1×1 mesh (a process of its own, as
    tests/_parallel_step_worker.py runs meshed steps): the post-step table,
    codebook, statistics and metrics into ``out_path``."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from segsplat_tpu.core.types import stack_cameras
    from segsplat_tpu.parallel.mesh import make_mesh
    from segsplat_tpu.parallel.train import make_parallel_train_step
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    state, opts, cfg, jcams, _, gts, gtos = _jax_batch()
    mesh = make_mesh(n_view=1, n_tensor=1, devices=jax.devices()[:1])
    step = make_parallel_train_step(cfg, opts, mesh, dict(STEP_RASTER, backend="xla",
                                                          tile_chunk=16))
    rngs = jax.random.split(jax.random.PRNGKey(JAX_KEY), 2)
    new, metrics = step(state, stack_cameras(jcams), jnp.asarray(np.stack(gts)),
                        jnp.asarray(np.stack(gtos)), jnp.zeros(3), rngs)
    out = {f: np.asarray(getattr(new.table, f)) for f in PARAM_FIELDS}
    out.update(code_book=np.asarray(new.code_book), step=np.asarray(new.step),
               **{k: np.asarray(v) for k, v in new.stats._asdict().items()},
               **{"m_" + k: np.asarray(v) for k, v in metrics.items()})
    np.savez(out_path, **out)
    print("WORKER_OK", flush=True)


def _update_close(got, old, new_ref, name):
    """tests/test_torch_train_step.py's post-step tolerance: the update's own
    gradient tolerance plus one float32 rounding of the parameter."""
    upd = new_ref - old
    tol = (5e-3 * np.abs(upd) + 2e-4 * np.abs(upd).max()
           + 2 * np.spacing(np.abs(old).astype(np.float32)))
    assert (np.abs(got - new_ref) <= tol).all(), name


def test_b2_step_at_world_1_matches_jax_parallel_step(tmp_path):
    import subprocess

    import jax
    import jax.numpy as jnp

    from segsplat_tpu_torch.convert import train_state_from_jax_arrays
    from segsplat_tpu_torch.core.types import stack_cameras
    from segsplat_tpu_torch.parallel import make_mesh, make_parallel_train_step
    from segsplat_tpu_torch.train import trainer as PT
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    out_path = str(tmp_path / "jax_step.npz")
    r = subprocess.run([sys.executable, HERE, "jax_step", out_path], capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0 and "WORKER_OK" in r.stdout, r.stderr[-3000:]
    ref = dict(np.load(out_path))

    state, _, _, _, pcams, gts, gtos = _jax_batch()
    ps = train_state_from_jax_arrays(jax.tree.map(np.asarray, state),
                                     PT.OptimizationConfig(num_classes=16), 2.0, device="cpu")
    rngs = jax.random.split(jax.random.PRNGKey(JAX_KEY), 2)
    idx = torch.stack([torch.from_numpy(np.array(jax.random.randint(
        jax.random.split(k)[0], (32768,), 0, H * W))).long() for k in rngs])
    step = make_parallel_train_step(PT.OptimizationConfig(num_classes=16), make_mesh(),
                                    STEP_RASTER)
    metrics = step(ps, stack_cameras(pcams), [torch.from_numpy(g) for g in gts],
                   [torch.from_numpy(g) for g in gtos], torch.zeros(3), idx=idx)
    assert ps.step == int(ref["step"]) == PARALLEL_STEP + 1
    for k in ("l1", "dssim", "contrastive", "cls", "clustering", "reg", "total", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(ref["m_" + k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    assert float(metrics["cls"]) > 0 and float(metrics["clustering"]) > 0
    # the JAX dense blend reports no num_pairs
    assert int(metrics["tile_overflow"]) == int(ref["m_tile_overflow"])
    g_ref = ref["grad_accum"]
    np.testing.assert_allclose(ps.stats.grad_accum.numpy(), g_ref, rtol=5e-3,
                               atol=2e-4 * np.abs(g_ref).max())
    np.testing.assert_array_equal(ps.stats.denom.numpy(), ref["denom"])
    assert ref["denom"].max() == 2, "some Gaussian must be seen by both views"
    np.testing.assert_array_equal(ps.stats.max_radii.numpy(), ref["max_radii"])
    for f in PARAM_FIELDS:
        _update_close(getattr(ps.table, f).detach().numpy(),
                      np.asarray(getattr(state.table, f)), ref[f], f)
    _update_close(ps.code_book.detach().numpy(), np.asarray(state.code_book),
                  ref["code_book"], "code_book")


def _close_to_world1(got: dict, ref: dict, label: str) -> None:
    for k, v in ref.items():
        if k.startswith("m_"):
            np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                       err_msg=f"{label} {k}")
        elif k in ("active", "denom", "max_radii"):
            np.testing.assert_array_equal(got[k], v, err_msg=f"{label} {k}")
        elif k.startswith("g_"):
            np.testing.assert_allclose(got[k], v, rtol=PARAM_RTOL,
                                       atol=PARAM_RTOL * np.abs(v).max(), err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{label} {k}")


@pytest.mark.parametrize("launch,world", [("step2", 2), ("step22", 4)])
def test_step_over_ranks_matches_world_1(ranks, world1, launch, world):
    """World 2 (view) and 2×2 (view × tensor) against world 1, gradients
    (``g_``, rtol 1e-4, atol 1e-4·max|ref|) included. The codebook's gradient
    and update at 2×2 are the test of the tensor-axis gradient: a gather whose
    backward summed over the tensor ranks would double the logits' part, a
    third of the codebook's gradient here."""
    first, _ = world1
    assert float(first["m_cls"]) > 0, "the codebook's logits must carry a gradient"
    moved = np.abs(first["code_book"] - port_train_setup(4)[0].code_book.detach().numpy())
    assert moved.max() > 0
    for rank in range(world):
        _close_to_world1(ranks(f"{launch}_rank{rank}"), first, f"{launch} rank {rank}")


@pytest.mark.parametrize("launch,world", [("step2", 2), ("step22", 4)])
def test_replicas_stay_bit_equal_after_a_densify_step(ranks, world1, launch, world):
    _, second = world1
    runs = [ranks(f"{launch}_second_rank{rank}") for rank in range(world)]
    assert runs[0]["active"].sum() > world1[0]["active"].sum(), "the densify step must add rows"
    for rank, got in enumerate(runs[1:], 1):
        for k, v in runs[0].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{launch} rank {rank} {k}")
    _close_to_world1(runs[0], second, f"{launch} after densify")



def test_make_parallel_train_step_checks_its_batch():
    from segsplat_tpu_torch.parallel.mesh import Mesh
    from segsplat_tpu_torch.parallel import make_parallel_train_step

    state, cfg, cams, gts, objs = port_train_setup(1)
    with pytest.raises(ValueError, match="tensor=3 does not divide the 256"):
        make_parallel_train_step(cfg, Mesh(1, 3, 0, 0), STEP_RASTER)
    step = make_parallel_train_step(cfg, Mesh(2, 1, 0, 0), STEP_RASTER)
    from segsplat_tpu_torch.core.types import stack_cameras

    with pytest.raises(ValueError, match="view batch 1 does not split over view=2"):
        step(state, stack_cameras(cams), gts, objs, torch.zeros(3))


# ───────────────────────────── the mesh and the cameras ─────────────────────────────

def test_stack_cameras_matches_jax_and_indexes_back():
    import jax.numpy as jnp

    from segsplat_tpu.core.types import Camera as JaxCamera
    from segsplat_tpu.core.types import stack_cameras as jax_stack_cameras
    from segsplat_tpu_torch.core.types import stack_cameras

    cams = port_train_setup(3)[2]
    batch = stack_cameras(cams)
    ref = jax_stack_cameras([JaxCamera(R=jnp.asarray(c.R.numpy()), T=jnp.asarray(c.T.numpy()),
                                       fov_x=jnp.asarray(float(c.fov_x)),
                                       fov_y=jnp.asarray(float(c.fov_y)),
                                       width=c.width, height=c.height) for c in cams])
    for name in ("R", "T", "fov_x", "fov_y"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert (batch.width, batch.height) == (ref.width, ref.height) == (W, H)
    for v, c in enumerate(cams):
        back = batch[v]
        for name in ("R", "T", "fov_x", "fov_y"):
            assert torch.equal(getattr(back, name), getattr(c, name)), name
        assert torch.equal(back.world_view_transform(), c.world_view_transform())
    assert batch[1:].R.shape == (2, 3, 3)
    with pytest.raises(TypeError, match="camera batch"):
        cams[0][0]
    other = type(cams[0])(R=cams[0].R, T=cams[0].T, fov_x=cams[0].fov_x,
                          fov_y=cams[0].fov_y, width=W, height=H + 16)
    with pytest.raises(ValueError, match="mixed resolutions"):
        stack_cameras([cams[0], other])


def test_shards_and_the_mesh_without_a_process_group():
    from segsplat_tpu_torch.parallel.mesh import (Mesh, channel_shard, make_mesh,
                                                  shard_range, view_shard)

    assert [shard_range(3, 2, i) for i in range(2)] == [(0, 2), (2, 3)]
    assert [shard_range(1, 2, i) for i in range(2)] == [(0, 1), (1, 1)]
    x = torch.arange(24).reshape(4, 6)
    assert torch.equal(view_shard(x, Mesh(2, 3, 1, 2)), x[2:])
    assert torch.equal(channel_shard(x, Mesh(2, 3, 1, 2), axis=1), x[:, 4:])
    with pytest.raises(ValueError, match="does not split"):
        channel_shard(x, Mesh(1, 4, 0, 0), axis=1)
    mesh = make_mesh()
    y = torch.ones(3)
    assert mesh.all_reduce(y, "view") is y and mesh.all_gather(y, "tensor") is y
    for kw in (dict(n_view=2), dict(n_tensor=2)):
        with pytest.raises(ValueError, match="ranks, but the process .* has 1"):
            make_mesh(**kw)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    if sys.argv[1] == "jax_step":
        jax_step(sys.argv[2])
    else:
        worker_main(sys.argv[2:], WORKERS)
