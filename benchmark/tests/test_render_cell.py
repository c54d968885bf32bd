"""The render cell's own files: the configuration loads through the harness
with its seven per-layer metrics, the plain reference of stage 5
(``reference/render.py``) loads nothing of the program or of JAX, the
scene's geometry is the configuration's for every ``--seed`` and its logits
repeat by seed, a run of the loop at a size this file cuts passes its check
and each planted fault fails it, and, on a card, the room's view 0 at full
size."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness.cell import load_cell
from benchmark.tests.conftest import REPO, tiny_copy
from benchmark.tests.test_benchmark_harness import run_cell

CELL = "render-cli-officescene"
PER_LAYER = {"render_fetch_ms.render", "render_post_ms.render", "render_enqueue_ms.render",
             "render_device_ms.render", "device_idle_pct.render", "render_mfu.render",
             "render_dropped.render"}
# the cell at a size the CPU holds: fewer, larger Gaussians and a 64×48 view
# with the configuration's field of view (fx 700 at 876 px)
CUT = {"gaussians": 3000, "log_scale_mean": -3.0, "width": 64, "height": 48,
       "native_w": 128, "native_h": 96, "fx_native": 1400.0 * 128 / 1752}
CUT_MIX = {"traced_iterations": 4, "keep_every": 3, "check_views": 2}


@pytest.fixture(scope="module")
def cut_root(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("render_cell"))
    for sub, name, cut in (("configs", "officescene-room-render", CUT),
                           ("traffic", "render", CUT_MIX)):
        p = root / "benchmark" / sub / f"{name}.json"
        d = json.loads(p.read_text())
        d.update(cut)
        p.write_text(json.dumps(d))
    torch.set_num_threads(2)
    return root


def test_the_configuration_loads_through_the_harness():
    c = load_cell(CELL)
    assert c.traffic["loop"] == "render" and c.chips == 1
    cfg = c.config
    assert (cfg["scene"], cfg["gaussians"], cfg["prompts"], cfg["channels"], cfg["width"],
            cfg["height"], cfg["max_tiles_per_axis"], cfg["max_per_tile"], cfg["pair_cap"],
            cfg["view_batch"], cfg["precision"], cfg["reduced"]) == (
        "room_render", 200_000, 13, 32, 876, 584, 6, 256, None, 8, "float32", [])
    assert {m["name"] for m in c.per_layer} == PER_LAYER
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}
    assert c.traffic["warmup"] == cfg["view_batch"] and c.traffic["traced_iterations"] == 16


def test_the_reference_of_stage_5_is_plain():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.render\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('segsplat_tpu_torch', 'segsplat_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "print(bad)\n" % str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_geometry_is_the_configurations_and_the_logits_repeat_by_seed():
    c = load_cell(CELL)
    scene = c.scene_module()
    small = dict(c.config, gaussians=2000)
    a, b, other = (scene.draw(small, s, "cpu") for s in (2 ** 31 + 7, 2 ** 31 + 7, 8))
    assert torch.equal(a["xyz"], other["xyz"]) and torch.equal(a["R"], other["R"])
    for k in ("log_scales", "quats", "logits"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], other[k]), k
    assert a["logits"].shape == (2000, 13) and torch.all(a["opacity_logit"] == 2.2)
    # the parts follow room_points' order: floor and ceiling shells first
    y, part = a["xyz"][:, 1].numpy(), a["parts"]
    assert np.abs(y[part == 0]).max() < 0.1 and np.abs(y[part == 1] - 2.8).max() < 0.1
    assert part.max() == 35 and len(part) == 2000
    # each Gaussian's boosted class is its part's
    assert (a["logits"].argmax(1).numpy() == part % 13).mean() > 0.7
    R, T, (fov_x, fov_y) = scene.cameras(c.config)
    assert R.shape == (216, 3, 3) and T.shape == (216, 3)
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-6)
    assert math.isclose(876 / (2 * math.tan(fov_x / 2)), 700.0, rel_tol=1e-9)
    assert math.isclose(584 / (2 * math.tan(fov_y / 2)), 700.0, rel_tol=1e-9)
    c2w, _ = scene.ROOM.cameras(c.config)
    assert np.allclose(-(R @ T[..., None])[..., 0], c2w[:, :3, 3], atol=1e-5)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cut_cell_runs_and_is_correct(cut_root, trace):
    from segsplat_tpu_torch.utils import profiling

    profiling.reset()
    rc, res = run_cell(cut_root, CELL, seed=3_000_000_023, trace=trace, seconds=0.5)
    assert rc == 0 and res["correct"] is True, res
    if trace:
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert PER_LAYER - {"render_device_ms.render", "device_idle_pct.render"} <= set(m)
        assert m["render_dropped.render"] == 0
        for name in ("render_fetch_ms.render", "render_post_ms.render",
                     "render_enqueue_ms.render", "render_mfu.render"):
            assert 0 < m[name] < 1e4, (name, m[name])
    else:
        assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("variant", ["control", "pair_cap_3m", "previous_view"])
def test_the_control_and_the_faults_fail_the_check(cut_root, variant):
    mod = load_cell(CELL, cut_root).loop_module()
    undo = []
    try:
        rc, res = run_cell(cut_root, CELL, seed=2_900_000_127,
                           patch=lambda loop: undo.append(mod.plant(loop, variant)))
    finally:
        for u in undo:
            u()
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_the_rooms_view_0_at_full_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from segsplat_tpu_torch.utils import profiling

    c = load_cell(CELL)
    loop = c.loop_module()
    lp = loop.Loop(c, 7, torch.device("cuda"))
    lp.mix = dict(lp.mix, warmup=0)
    lp.setup()
    profiling.enable()
    profiling.reset()
    try:
        rec = next(iter(lp.program_products(0, 1)))
    finally:
        profiling.disable()
    view = [r for r in profiling.records() if r.name == "render_cli.view"]
    assert len(view) == 1 and view[0].counts["dropped"] == 0
    assert view[0].counts["pairs"] == rec.num_pairs and 3e5 < rec.num_pairs < 7e5
    checks = dict(zip(loop.NUMBERS, loop.compare(rec, lp.reference_view(0))))
    for name, value in checks.items():
        assert value <= c.traffic["limits"][name], (name, value)
