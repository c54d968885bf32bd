"""The port's evaluation helpers (segsplat_tpu_torch/eval/metrics.py and
eval/parity.py, numpy copies of the JAX package's) against the originals on
seeded label maps, masks and artifacts, on the CPU. Tolerance: equal results
(the same numpy arithmetic); the parity CLI's exit codes as
tests/test_parity_golden.py checks them."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from segsplat_tpu.eval import metrics as JM
from segsplat_tpu.eval import parity as JP
from segsplat_tpu_torch.eval import metrics as M
from segsplat_tpu_torch.eval import parity as P
from segsplat_tpu_torch.io.artifacts import save_semantics, save_voxel_features
from segsplat_tpu_torch.io.ply import write_voxel_grid_ply
from tests.make_goldens import GOLD_DIR


def _masks(seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((40, 56)) > 0.5).astype(np.uint8) * 255
    b = a.copy()
    b[10:30, 8:20] = 255 - b[10:30, 8:20]
    return a, b


def _labels(seed, C=6):
    rng = np.random.default_rng(seed)
    gt = rng.integers(-1, C, (30, 44))
    pred = np.where(rng.random(gt.shape) < 0.7, gt, rng.integers(0, C + 2, gt.shape))
    return pred, gt, C


BINARY = {
    "mask_iou": lambda m, a, b: m.mask_iou(a, b),
    "boundary_iou": lambda m, a, b: m.boundary_iou(a, b),
    "boundary_iou_wide": lambda m, a, b: m.boundary_iou(a, b, dilation_ratio=0.1),
    "mask_to_boundary": lambda m, a, b: m._mask_to_boundary(a),
    "empty": lambda m, a, b: (m.mask_iou(a * 0, b * 0), m.boundary_iou(a * 0, b * 0)),
}
MULTICLASS = {
    "confusion_matrix": lambda m, p, g, c: m.confusion_matrix(p, g, c),
    "iou_per_class": lambda m, p, g, c: m.iou_per_class(m.confusion_matrix(p, g, c + 2)),
    "miou_from_confusion": lambda m, p, g, c: m.miou_from_confusion(
        m.confusion_matrix(p, g, c)),
    "mean_iou": lambda m, p, g, c: m.mean_iou(p, g, c),
    "fw_iou": lambda m, p, g, c: m.fw_iou(p, g, c),
    "ignore_label": lambda m, p, g, c: m.mean_iou(p, g, c, ignore_label=0),
    "psnr_np": lambda m, p, g, c: (m.psnr_np(p / 8.0, g / 8.0), m.psnr_np(g, g)),
}


@pytest.mark.parametrize("name", sorted(BINARY))
@pytest.mark.parametrize("seed", [0, 1])
def test_binary_mask_metrics_match_jax(name, seed):
    a, b = _masks(seed)
    np.testing.assert_array_equal(BINARY[name](M, a, b), BINARY[name](JM, a, b))


@pytest.mark.parametrize("name", sorted(MULTICLASS))
def test_multiclass_metrics_match_jax(name):
    pred, gt, C = _labels(2)
    np.testing.assert_array_equal(MULTICLASS[name](M, pred, gt, C),
                                  MULTICLASS[name](JM, pred, gt, C))


def test_parity_reports_match_jax_and_main_exit_codes(tmp_path, capsys):
    """Every comparison of the port's harness gives the JAX harness's reports,
    and ``main`` exits 0 on a clean diff and 1 on a failed one."""
    rng = np.random.default_rng(3)
    pos = (rng.integers(0, 20, (50, 3)) * 0.1).astype(np.float32)
    coords = rng.permutation(1000)[:50].reshape(50, 1) * np.array([[1, 1, 1]])
    feat = rng.random((50, 8)).astype(np.float32)
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    save_voxel_features(a, pos, feat, coords)
    save_voxel_features(b, pos, feat + 0.1 * (np.arange(50) < 10)[:, None], coords)
    logits = rng.standard_normal((50, 3)).astype(np.float32)
    sa, sb = str(tmp_path / "sa.npz"), str(tmp_path / "sb.npz")
    save_semantics(sa, logits.argmax(1), logits, ["wall", "chair", "floor"])
    save_semantics(sb, (logits.argmax(1) + 1) % 3, logits + 0.5, ["wall", "chair", "floor"])
    ga, gb = str(tmp_path / "ga.ply"), str(tmp_path / "gb.ply")
    cols = np.zeros((50, 3), np.uint8)
    write_voxel_grid_ply(ga, pos, cols, 0.1, np.zeros(3, np.float32))
    write_voxel_grid_ply(gb, pos[:45], cols[:45], 0.1, np.zeros(3, np.float32))

    for kind, pairs in (("voxel_features", [(a, a), (a, b)]),
                        ("semantics", [(sa, sa), (sa, sb)]),
                        ("voxel_grid", [(ga, ga), (ga, gb)]),
                        ("label_maps", [(GOLD_DIR, GOLD_DIR), (str(tmp_path), GOLD_DIR)])):
        name = "compare_voxel_grids" if kind == "voxel_grid" else f"compare_{kind}"
        fn, jfn = (getattr(m, name) for m in (P, JP))
        for ours, theirs in pairs:
            assert [r.line() for r in fn(ours, theirs)] == [r.line() for r in jfn(ours, theirs)]
        codes = []
        for ours, theirs in pairs:
            with pytest.raises(SystemExit) as e:
                P.main([kind, ours, theirs])
            codes.append(e.value.code)
        assert codes == [0, 1], kind
    assert "[FAIL]" in capsys.readouterr().out
