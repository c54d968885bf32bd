"""The port's real-artifact parity (segsplat_tpu_torch/parity_real.py) against
scripts/parity_real.py on the same seeded label maps in the reference's format
({'label_indices': [H, W] int64} .pt files under
<root>/semantics_*/train/labels/): the round trip, the histograms, the
cross-variant confusion matrices (exact) with their mIoU and fwIoU (1e-12), the
same report tables, and a run that writes nothing but its ``--out``."""

import hashlib
import os
import sys

import numpy as np
import pytest

from _torch_port import write_label_maps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS, H, W = 8, 24, 36


@pytest.fixture(scope="module")
def ref_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    write_label_maps(str(root), VIEWS, H, W)
    return str(root)


def _jax_script():
    sys.path.insert(0, ROOT)
    try:
        from scripts import parity_real as J
    finally:
        sys.path.remove(ROOT)
    return J


def test_checks_match_the_jax_script(ref_root):
    from segsplat_tpu.eval.metrics import iou_per_class, miou_from_confusion
    from segsplat_tpu_torch import parity_real as P

    J = _jax_script()
    variants = P.find_variants(ref_root)
    assert variants == J.find_variants(ref_root) and len(variants) == 3
    C = len(P.OFFICESCENE_PROMPTS)
    assert P.OFFICESCENE_PROMPTS == J.OFFICESCENE_PROMPTS and P.VARIANTS == J.VARIANTS
    for files in variants.values():
        assert len(files) == VIEWS
        assert P.roundtrip_check(files) == J.roundtrip_check(files) == VIEWS
        counts, shapes = P.histogram(files, C)
        ref_counts, ref_shapes = J.histogram(files, C)
        np.testing.assert_array_equal(counts, ref_counts)
        assert shapes == ref_shapes == {(H, W)} and counts.sum() == VIEWS * H * W
    names = list(variants)
    for i in range(3):
        for j in range(i + 1, 3):
            conf, matched = P.cross_variant(variants[names[i]], variants[names[j]], C)
            ref, ref_matched = J.cross_variant(variants[names[i]], variants[names[j]], C)
            np.testing.assert_array_equal(conf, ref)
            assert matched == ref_matched == VIEWS
            s = P.pair_scores(conf)
            iou = iou_per_class(ref)
            freq = ref.sum(axis=1) / ref.sum()
            assert abs(s["miou"] - miou_from_confusion(ref)) <= 1e-12
            assert abs(s["fwiou"] - float(np.nansum(np.where(np.isnan(iou), 0.0, iou) * freq))) \
                <= 1e-12
            assert 0.4 < s["acc"] < 1.0


def _tree_digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_main_writes_only_its_out(ref_root, tmp_path, monkeypatch):
    """The twin's report holds the JAX script's tables; the run leaves the
    reference tree, its working directory and the repo's PARITY_REAL.md as
    they were."""
    from segsplat_tpu_torch import parity_real as P

    monkeypatch.chdir(tmp_path)
    before = _tree_digest(ref_root)
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    repo_report = digest(os.path.join(ROOT, "PARITY_REAL.md"))
    out = tmp_path / "report.md"
    P.main(["--ref_root", ref_root, "--out", str(out), "--max_views", str(VIEWS)])
    assert sorted(os.listdir(tmp_path)) == ["report.md"]
    assert _tree_digest(ref_root) == before
    assert digest(os.path.join(ROOT, "PARITY_REAL.md")) == repo_report

    jax_out = tmp_path.parent / f"{tmp_path.name}_jax.md"
    _jax_script().main(["--ref_root", ref_root, "--out", str(jax_out),
                        "--max_views", str(VIEWS)])
    rows = lambda text: [line for line in text.splitlines()
                         if line.startswith(("|", "- ", "### "))
                         and "round-tripped" not in line]
    ours, ref = rows(out.read_text()), rows(jax_out.read_text())
    assert ours == ref and len(ours) > 3 * 13
    with pytest.raises(SystemExit):
        P.main(["--ref_root", ref_root])
    with pytest.raises(SystemExit):
        P.main(["--out", str(out)])
