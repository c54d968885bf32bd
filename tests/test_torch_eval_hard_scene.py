"""The offline pseudo-label tools of the port against the JAX scripts:
eval_hard_scene_checkpoint (a ``--save_at`` snapshot scored again),
eval_hard_scene_offline (``rescore`` of a saved ``merge_debug.npz``),
tune_class_merge and tune_tracker. The port's loop runs once, at
tests/test_eval_checkpoint.py's size (6 frames at 64², capacity 1024) but for
20 iterations, not 60, with a snapshot at 20, on the CPU (its training takes
most of the file's time); the JAX loop does not run. Both
packages score the port's snapshot and its files alike, key for key, and the
snapshot's score agrees with the loop's own within test_eval_checkpoint.py's
0.05."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import scripts.eval_hard_scene_checkpoint as JC  # noqa: E402
import scripts.eval_hard_scene_offline as JO  # noqa: E402
import scripts.tune_class_merge as JM  # noqa: E402
import scripts.tune_tracker as JT  # noqa: E402
from segsplat_tpu.pipeline.consolidate import ClassMergeConfig as JaxMergeConfig  # noqa: E402
from segsplat_tpu.pipeline.consolidate import consolidate_classes as jax_consolidate  # noqa: E402

from segsplat_tpu_torch import eval_hard_scene_checkpoint as TC  # noqa: E402
from segsplat_tpu_torch import eval_hard_scene_offline as TO  # noqa: E402
from segsplat_tpu_torch import pseudo_label_loop as L  # noqa: E402
from segsplat_tpu_torch import tune_class_merge as TM  # noqa: E402
from segsplat_tpu_torch import tune_tracker as TT  # noqa: E402
from _torch_port import torch_threads  # noqa: E402

ITERS = 20
SNAPSHOT = dict(frames=6, size=64, n_objects=5, layout="fixed", textured=False, seed=0,
                max_per_tile=512, capacity=1024)
RECORDED = os.path.join(os.path.dirname(__file__), "..", "results", "hard_scene",
                        "merge_debug.npz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's loop with a snapshot at its last iteration. Two torch threads:
    one long sequence of mid-sized tensor ops."""
    root = str(tmp_path_factory.mktemp("loop"))
    with torch_threads(2), contextlib.redirect_stdout(io.StringIO()):
        r = L.run_loop(root, frames=6, H=64, W=64, iterations=ITERS, capacity=1024,
                       quiet=True, save_at=(ITERS,), device="cpu")
    return root, r


def test_checkpoint_scores_match_jax_and_the_loop(run):
    root, r = run
    it_dir = os.path.join(root, "model", "point_cloud", f"iteration_{ITERS}")
    assert os.path.exists(os.path.join(it_dir, "classifier.npz"))
    got = TC.eval_checkpoint(root, ITERS, device="cpu", **SNAPSHOT)
    npz = os.path.join(root, f"merge_debug_iter{ITERS}.npz")
    port_npz = dict(np.load(npz))
    want = JC.eval_checkpoint(root, ITERS, **SNAPSHOT)
    assert got == want
    for k, v in np.load(npz).items():             # the JAX run wrote it last
        np.testing.assert_array_equal(port_npz[k], v, err_msg=k)
    for key in ("post_train_identity_miou_grouped", "post_train_identity_miou_1to1",
                "background_iou"):
        assert abs(got[key] - r[key]) < 0.05, (key, got[key], r[key])
    assert abs(got["class_merge"]["grouped"] - r["class_merge"]["grouped"]) < 0.05


def test_rescore_matches_jax(run):
    root, _ = run
    rec = TO.rescore(RECORDED, 20)
    assert rec == JO.rescore(RECORDED, 20)
    # the recorded hard-scene run's own numbers (hard_slic_rescore.json)
    assert (rec["post_train_identity_miou_grouped"], rec["post_train_identity_miou_1to1"]) == (
        0.4546, 0.3979)
    npz = os.path.join(root, "merge_debug.npz")
    kw = dict(mix_threshold=0.02, feat_threshold=-1.0)
    assert TO.rescore(npz, 5, **kw) == JO.rescore(npz, 5, **kw)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = TO.main([root, "--n_objects", "5"])
    assert json.loads(printed.getvalue()) == out == JO.rescore(npz, 5)


def test_tune_class_merge_matches_jax_rows():
    """A 2×2 grid of thresholds on the recorded run's npz; the JAX rows come
    from the JAX script's own score and remap around the JAX consolidation."""
    mix, feat = (0.04, 0.08), (0.0, 0.5)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = TM.sweep(RECORDED, 20, mix, feat)
    d = np.load(RECORDED)
    n_pred = d["code_book"].shape[0] + 1
    g0, s0 = JM.score(d["preds"], d["gts"], n_pred, 20)
    want = [{"criterion": "none", "grouped": g0, "strict": s0}]
    for m in mix:
        for f in feat:
            stats = {}
            remap = jax_consolidate(d["objects_dc"], d["code_book"], d["xyz"], active=d["active"],
                                    cfg=JaxMergeConfig(mix_threshold=m, feat_threshold=f),
                                    stats=stats)
            merged = int((remap[1:] != np.arange(1, len(remap))).sum())
            g, s = JM.score(JM.apply_remap(d["preds"], remap), d["gts"], n_pred, 20)
            want.append({"criterion": f"mix>={m},cos>={f}", "grouped": round(g, 4),
                         "strict": round(s, 4), "merged": merged,
                         "merge_pairs": stats.get("n_merge_pairs")})
    assert rows == want
    assert TM.best_row(rows) == max(want, key=lambda r: (r["strict"], r["grouped"]))


def test_tune_tracker_matches_jax(run, tmp_path):
    root, _ = run
    out = {}
    for k, main in (("jax", JT.main), ("port", TT.main)):
        path = str(tmp_path / f"{k}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            main([root, "--n_objects", "5", "--out", path])
        out[k] = json.load(open(path))
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 2 * len(TT.VARIANTS)
