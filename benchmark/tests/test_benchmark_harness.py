"""CPU tests of the benchmark's harness: the contract of BENCHMARK.json, the
files it is driven by, the seeded draws, the modules it loads, the copied
bounds, and whole runs of each cell at a size the CPU holds."""

import contextlib
import hashlib
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cameras, roofline
from benchmark.harness.cell import load_cell
from benchmark.harness.runner import run
from benchmark.tests.conftest import REPO, tiny_copy

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run_cell(root, workload, seed=5, trace=0, seconds=0.5, patch=None):
    """(exit code, the result's line or None) of an in-process run on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", str(trace)], time.perf_counter(), device="cpu", patch=patch,
                 root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert all(m["source"] in ("host_clock", "device_trace") for m in SPEC["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in metrics:
        if m["name"] != "setup_s":
            assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for cell in CELLS:
        c = load_cell(cell)
        assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
        assert c.per_layer


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_and_is_correct_on_the_cpu(tiny_root, cell, trace):
    rc, res = run_cell(tiny_root, cell, seed=3_000_000_017, trace=trace)
    assert rc == 0 and res["correct"] is True, res
    assert list(res)[-1] == "checks" and res["attempted"] >= 1 and res["failed"] == 0
    c = load_cell(cell, tiny_root)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


def test_a_new_configuration_mix_and_metric_need_no_edit(tmp_path):
    """A later PR adds a cell, a mix and a per-layer metric as files and
    BENCHMARK.json entries; no existing file of the benchmark changes."""
    root = tiny_copy(tmp_path)
    bench = root / "benchmark"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "officescene-semantic32.json").read_text())
    cfg.update(name="small-semantic", gaussians=1500)
    (bench / "configs" / "small-semantic.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "view.json").read_text())
    mix["path"]["amplitude_rad"] = 0.05
    mix["frame"].update(width=48, height=32)
    (bench / "traffic" / "view-slow.json").write_text(json.dumps(mix))
    (bench / "metrics" / "kept_frames.small.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['count'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "small-semantic", "source": "test",
                            "file": "benchmark/configs/small-semantic.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "small.slow", "config": "small-semantic",
                              "traffic": "view-slow", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "kept_frames.small", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "test",
                              "moves": "frames_per_s", "workloads": ["small.slow"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
            m["workloads"].append("small.slow")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res = run_cell(root, "small.slow", trace=1)
    assert rc == 0 and res["correct"] and res["metrics"]["kept_frames.small"]["value"] >= 1
    rc, res = run_cell(root, "small.slow", trace=0)
    assert rc == 0 and set(res["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


@pytest.mark.parametrize("scene,config", [("box_render", "officescene-semantic32"),
                                          ("box_train", "officescene-unifiedlift")])
def test_scene_draws_repeat_by_seed(tiny_root, scene, config):
    cell = next(c for c in CELLS if load_cell(c, tiny_root).config["scene"] == scene)
    c = load_cell(cell, tiny_root)
    draw = c.scene_module().draw
    a, b, other = draw(c.config, 2 ** 31 + 7, "cpu"), draw(c.config, 2 ** 31 + 7, "cpu"), \
        draw(c.config, 8, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], other[k]), k


@pytest.mark.parametrize("mix", ["view", "train"])
def test_paths_repeat_by_seed_and_never_repeat_a_pose(mix):
    params = json.loads((REPO / "benchmark" / "traffic" / f"{mix}.json").read_text())["path"]
    a = cameras.yaws(params, 2 ** 31 + 11, 20_000)
    assert np.array_equal(a, cameras.yaws(params, 2 ** 31 + 11, 20_000))
    assert len(np.unique(a)) == len(a)
    assert np.abs(a).max() <= params["amplitude_rad"] + params["jitter_rad"]
    b = cameras.yaws(params, 12, 20_000)
    assert not np.array_equal(a, b)
    # two seeds visit the same poses in another order: the same spread of yaws
    assert abs(np.std(a) - np.std(b)) < 0.02 * params["amplitude_rad"]
    R = cameras.rotations(params, 3, 50, "cpu")
    assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3).expand(50, 3, 3), atol=1e-6)


def test_nothing_of_jax_is_loaded_and_the_reference_is_plain():
    """The run's modules, the program's path among them, load neither JAX nor
    the JAX package (top-level names compared whole); the reference loads
    nothing of the program."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.raster, benchmark.reference.train\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'segsplat_tpu_torch'], 'ref'\n"
        "from benchmark.harness import runner, cell\n"
        "for w in %r:\n"
        "    c = cell.load_cell(w); c.loop_module(); c.scene_module()\n"
        "    [c.reader(m['name']) for m in c.per_layer + c.end_to_end\n"
        "     if m['name'] != 'setup_s']\n"
        "import segsplat_tpu_torch.render, segsplat_tpu_torch.train.trainer\n"
        "print(runner.forbidden_modules())\n" % (str(REPO), CELLS))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark.harness.runner import forbidden_modules

    monkeypatch.setitem(sys.modules, "segsplat_tpu_torch_like", sys)
    assert "segsplat_tpu_torch_like" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in forbidden_modules()


def test_copied_bounds_give_chip_smokes_values():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for rows, hits, ch, tiles in ((1_202_375, 90_000_000, 32, 8160), (400_000, 3e7, 19, 2035),
                                  (10, 100, 51, 4)):
        offsets = torch.zeros(tiles + 1, dtype=torch.int32)
        assert roofline.k1_bound(rows, hits, ch, tiles) == cs.k1_bound(offsets, rows, hits, ch,
                                                                        tiles)
        assert roofline.k2_bound(rows + 256, rows, hits, ch, tiles) == cs.k2_bound(
            offsets, rows + 256, rows, hits, ch, tiles)
    assert (roofline.PEAK_FP32_FLOPS, roofline.PEAK_HBM_BYTES) == (cs.PEAK_FP32_FLOPS,
                                                                   cs.PEAK_HBM_BYTES)


def test_a_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == "", r.stdout


def test_a_checkout_without_the_program_prints_no_result(tiny_root, tmp_path):
    shutil.copy(tiny_root / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny_root / "benchmark", tmp_path / "benchmark")
    code = ("import sys, time; from pathlib import Path; sys.path = [p for p in sys.path "
            "if p not in ('', %r)]; sys.path.insert(0, %r)\n"
            "from benchmark.harness.runner import run\n"
            "sys.exit(run(['--workload', %r, '--seed', '1', '--seconds', '0.2', '--trace', '0'],"
            " time.perf_counter(), device='cpu', root=Path(%r)))\n"
            % (str(REPO), str(tmp_path), CELLS[0], str(tmp_path)))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == "" and "segsplat_tpu_torch" in r.stderr


@pytest.mark.cuda
def test_each_cell_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for cell in CELLS:
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                            "7", "--seconds", "2", "--trace", "0"], cwd=REPO,
                           capture_output=True, text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-2000:]
        assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True


def test_trace_summary_leaves_out_the_harness_asides():
    """The window less the ``bench.aside`` ranges; device work launched there
    is no one's; each idle gap is named by the host event covering it."""
    from benchmark.harness.trace import summarise

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        return e if corr is None else {**e, "args": {"correlation": corr}}

    s = summarise([x("user_annotation", "bench.window", 0, 100),
                   x("user_annotation", "bench.aside", 10, 20),
                   x("user_annotation", "bench.iter", 30, 60),
                   x("cuda_runtime", "cudaLaunchKernel", 31, 2, 1),
                   x("cuda_runtime", "cudaMemcpyAsync", 12, 2, 2),
                   x("kernel", "k", 40, 20, 1), x("gpu_memcpy", "snapshot", 15, 5, 2),
                   x("cpu_op", "aten::mul", 60, 30)])
    assert s["window_s"] == pytest.approx(80e-6) and s["busy_s"] == pytest.approx(20e-6)
    assert s["device_s"] == pytest.approx({"k": 20e-6}) and s["iterations"] == 1
    assert s["idle_by_host"] == pytest.approx({"host idle": 10e-6, "bench.iter": 10e-6,
                                               "aten::mul": 40e-6})


def test_idle_share_is_traced_busy_time_over_the_untimed_period():
    """The profiler stretches the host's time but not the device's, so the
    idle share takes the device's traced busy time an iteration over the
    untraced window's mean period."""
    from benchmark.harness.trace import idle_pct

    window = {"window_s": 1.0, "count": 100}
    assert idle_pct({"busy_s": 0.02, "iterations": 4, "window_s": 0.2}, window) == \
        pytest.approx(50.0)
    assert idle_pct(None, window) is None
    assert idle_pct({"busy_s": 0.0, "iterations": 4}, window) is None
