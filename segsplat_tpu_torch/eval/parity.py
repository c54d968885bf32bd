"""Artifact parity harness (a copy of segsplat_tpu/eval/parity.py, reading the
artifacts through the port's io/) — element-wise comparison of stage
outputs against reference-produced files (SURVEY §7: "parity harness that diffs
our artifacts against reference outputs"; BASELINE.md bit-closeness target).

Covers every inter-stage contract: voxel-feature dumps ({xyz, avg_feats,
voxel_coords}), gaussian→voxel maps, semantics .npz ({labels, logits, prompts}),
per-view label maps, and voxel-grid PLYs (centers + header metadata).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.artifacts import load_label_map, load_semantics, load_voxel_features
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply


@dataclasses.dataclass
class ParityReport:
    name: str
    max_abs: float = 0.0
    rel: float = 0.0
    mismatch_frac: float = 0.0
    note: str = ""
    ok: bool = True

    def line(self) -> str:
        flag = "OK " if self.ok else "FAIL"
        return (f"[{flag}] {self.name}: max_abs={self.max_abs:.3e} "
                f"rel={self.rel:.3e} mismatch={self.mismatch_frac * 100:.2f}% "
                f"{self.note}")


def _compare(name, a, b, rtol=1e-3, atol=1e-4) -> ParityReport:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return ParityReport(name, ok=False, note=f"shape {a.shape} vs {b.shape}")
    if a.size == 0:
        return ParityReport(name, note="empty")
    diff = np.abs(a - b)
    denom = np.abs(b).max() + 1e-12
    mism = float((diff > (atol + rtol * np.abs(b))).mean())
    return ParityReport(name, max_abs=float(diff.max()),
                        rel=float(diff.max() / denom),
                        mismatch_frac=mism, ok=mism < 0.005)


def compare_voxel_features(ours: str, theirs: str,
                           match_by_coord: bool = True) -> list:
    """Voxel-feature artifacts; rows are matched by voxel coordinate (the two
    implementations may enumerate voxels in different orders)."""
    a = load_voxel_features(ours)
    b = load_voxel_features(theirs)
    reports = []
    if match_by_coord and "coords" in a and "coords" in b:
        ka = {tuple(c): i for i, c in enumerate(np.asarray(a["coords"]))}
        kb = {tuple(c): i for i, c in enumerate(np.asarray(b["coords"]))}
        common = sorted(set(ka) & set(kb))
        missing = 1.0 - len(common) / max(len(kb), 1)
        reports.append(ParityReport("voxel_sets", mismatch_frac=missing,
                                    ok=missing < 0.01,
                                    note=f"{len(common)} common voxels"))
        ia = np.array([ka[c] for c in common])
        ib = np.array([kb[c] for c in common])
        reports.append(_compare("avg_feats", a["feat"][ia], b["feat"][ib],
                                rtol=2e-3, atol=2e-3))
        reports.append(_compare("xyz", a["pos"][ia], b["pos"][ib],
                                rtol=1e-5, atol=1e-5))
    else:
        reports.append(_compare("avg_feats", a["feat"], b["feat"]))
        reports.append(_compare("xyz", a["pos"], b["pos"]))
    return reports


def compare_semantics(ours: str, theirs: str) -> list:
    a = load_semantics(ours)
    b = load_semantics(theirs)
    reports = [ParityReport("prompts",
                            ok=list(map(str, a["prompts"])) == list(
                                map(str, b["prompts"])),
                            note=str(list(map(str, a["prompts"]))))]
    lab_mism = float((np.asarray(a["labels"]) != np.asarray(b["labels"])).mean())
    reports.append(ParityReport("labels", mismatch_frac=lab_mism,
                                ok=lab_mism < 0.01))
    reports.append(_compare("logits", a["logits"], b["logits"], rtol=5e-3,
                            atol=5e-3))
    return reports


def compare_label_maps(ours_dir: str, theirs_dir: str) -> list:
    reports = []
    ours = {os.path.basename(f) for f in
            glob.glob(os.path.join(ours_dir, "*_labels.pt"))}
    theirs = {os.path.basename(f) for f in
              glob.glob(os.path.join(theirs_dir, "*_labels.pt"))}
    # a run that produced nothing (or fewer maps than the reference) must
    # FAIL, not vacuously pass over an empty glob
    for base in sorted(theirs - ours):
        reports.append(ParityReport(base, ok=False, note="missing in ours"))
    if not ours:
        reports.append(ParityReport("(no *_labels.pt in ours)", ok=False,
                                    note=ours_dir))
        return reports
    for base in sorted(ours):
        f = os.path.join(ours_dir, base)
        other = os.path.join(theirs_dir, base)
        if not os.path.exists(other):
            reports.append(ParityReport(base, ok=False, note="missing peer"))
            continue
        a, b = load_label_map(f), load_label_map(other)
        mism = float((a != b).mean()) if a.shape == b.shape else 1.0
        reports.append(ParityReport(base, mismatch_frac=mism, ok=mism < 0.01))
    return reports


def compare_voxel_grids(ours: str, theirs: str) -> list:
    ca, cola, vsa, oa, sa = read_voxel_grid_ply(ours)
    cb, colb, vsb, ob, sb = read_voxel_grid_ply(theirs)
    if vsa is None or vsb is None:
        # missing voxel_size header: fail explicitly instead of crashing in
        # the coordinate quantization below (None == None is NOT parity)
        return [ParityReport("voxel_size", ok=False,
                             note=f"missing header: {vsa} vs {vsb}")]
    rep = [ParityReport("voxel_size", ok=(vsa == vsb),
                        note=f"{vsa} vs {vsb}")]
    seta = {tuple(np.round(c / vsa).astype(int)) for c in ca - (oa if oa is not None else 0)}
    setb = {tuple(np.round(c / vsb).astype(int)) for c in cb - (ob if ob is not None else 0)}
    inter = len(seta & setb)
    iou = inter / max(len(seta | setb), 1)
    rep.append(ParityReport("voxel_set_iou", rel=1 - iou, ok=iou > 0.99,
                            note=f"IoU {iou:.4f} ({len(ca)} vs {len(cb)})"))
    return rep


def main(argv=None):
    p = ArgumentParser(description="Diff stage artifacts against a reference run")
    sp = p.add_subparsers(dest="kind", required=True)
    for kind in ("voxel_features", "semantics", "label_maps", "voxel_grid"):
        s = sp.add_parser(kind)
        s.add_argument("ours")
        s.add_argument("theirs")
    args = p.parse_args(argv)
    fn = {"voxel_features": compare_voxel_features,
          "semantics": compare_semantics,
          "label_maps": compare_label_maps,
          "voxel_grid": compare_voxel_grids}[args.kind]
    reports = fn(args.ours, args.theirs)
    ok = True
    for r in reports:
        print(r.line())
        ok &= r.ok
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
