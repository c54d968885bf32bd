"""Post-train class consolidation of the port (segsplat_tpu_torch/pipeline/
consolidate.py, a numpy copy) against the JAX package's, on
tests/test_consolidate.py's scenes and on the hard scene's trained state
(results/hard_scene/merge_debug.npz: 8 192 Gaussians, a [256, 16] codebook,
30 predicted and GT maps at 256²): identical remaps and statistics. The port's
``match_miou`` (pseudo_label_loop.py, matching on the host Jonker–Volgenant)
reproduces results/hard_scene/hard_slic_rescore.json from the same maps."""

import json
from pathlib import Path

import numpy as np
import pytest

from segsplat_tpu.pipeline import consolidate as JC
from segsplat_tpu_torch.pipeline import consolidate as TC
from segsplat_tpu_torch.pseudo_label_loop import match_miou
from test_consolidate import _make_scene

HARD = Path(__file__).resolve().parents[1] / "results" / "hard_scene"


def _disagreeing():
    rng = np.random.default_rng(1)
    code_book = np.eye(2, 16, dtype=np.float32)
    xyz = rng.normal(0, 0.12, (400, 3)).astype(np.float32)
    cls = rng.integers(0, 2, 400)
    feat = (code_book[cls] + rng.normal(0, 0.05, (400, 16))).astype(np.float32)
    return feat, code_book, xyz


CASES = {
    "interleaved_seed0": (lambda: _make_scene(0), {}, None),
    "interleaved_seed3": (lambda: _make_scene(3), {}, None),
    "features_disagree": (_disagreeing, {}, None),
    "small_class_guard": (lambda: _make_scene(0), dict(min_gaussians=10_000), None),
    "nothing_active": (lambda: _make_scene(0), {}, "none"),
    "half_active_small_chunks": (lambda: _make_scene(2), dict(chunk=97, k_neighbors=5), "half"),
}


def _consolidate(pkg, feat, code_book, xyz, active, cfg):
    stats = {}
    remap = pkg.consolidate_classes(feat, code_book, xyz, active=active,
                                    cfg=pkg.ClassMergeConfig(**cfg), stats=stats)
    return remap, stats


@pytest.mark.parametrize("case", sorted(CASES))
def test_consolidate_classes_gives_identical_remaps(case):
    make, cfg, act = CASES[case]
    feat, code_book, xyz = make()
    active = {None: None, "none": np.zeros(len(xyz), bool),
              "half": np.arange(len(xyz)) % 2 == 0}[act]
    want = _consolidate(JC, feat, code_book, xyz, active, cfg)
    got = _consolidate(TC, feat, code_book, xyz, active, cfg)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1] == want[1]
    np.testing.assert_array_equal(TC.classify_gaussians(feat, code_book),
                                  JC.classify_gaussians(feat, code_book))


@pytest.fixture(scope="module")
def hard():
    d = np.load(HARD / "merge_debug.npz")
    return {k: d[k] for k in d.files}


@pytest.mark.parametrize("cfg", (dict(), dict(mix_threshold=0.02, feat_threshold=0.5),
                                 dict(mix_threshold=0.05, feat_threshold=0.7, k_neighbors=12)))
def test_hard_scene_remap_is_identical(hard, cfg):
    args = (hard["objects_dc"], hard["code_book"], hard["xyz"], hard["active"], cfg)
    want = _consolidate(JC, *args)
    got = _consolidate(TC, *args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_hard_scene_scores_reproduce_the_recorded_rescore(hard):
    rec = json.loads((HARD / "hard_slic_rescore.json").read_text())
    preds, gts = list(hard["preds"]), list(hard["gts"])
    n_pred = hard["code_book"].shape[0] + 1
    grouped, per_obj, strict, bg = match_miou(preds, gts, n_pred, n_objects=20)
    assert round(grouped, 4) == rec["post_train_identity_miou_grouped"]
    assert [round(x, 4) for x in per_obj] == rec["per_object_iou_grouped"]
    assert round(strict, 4) == rec["post_train_identity_miou_1to1"]
    assert round(bg, 4) == rec["background_iou"]

    stats = {}
    remap = TC.consolidate_classes(hard["objects_dc"], hard["code_book"], hard["xyz"],
                                   active=hard["active"], stats=stats)
    grouped_m, _, strict_m, _ = match_miou([remap[p] for p in preds], gts, n_pred,
                                           n_objects=20)
    used = np.unique(np.concatenate([np.unique(p) for p in preds]))
    used = used[used > 0]
    merge = rec["class_merge"]
    assert round(grouped_m, 4) == merge["grouped"]
    assert round(strict_m, 4) == merge["strict_1to1"]
    assert len(used) == merge["rendered_classes_before"]
    assert len(np.unique(remap[used])) == merge["rendered_classes_after"]
    assert json.loads(json.dumps(stats)) == merge["stats"]
