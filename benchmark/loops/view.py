"""The semantic view loop: one client in a closed loop, as the viewer or the
render CLI drives the system. A frame is

    sem = segsplat_tpu_torch.render.render_semantics(table, camera, logits, m, K, pair_cap)
    labels = sem.argmax(0).cpu()

and the next frame starts once its labels are on the host. The frame and its
camera are the viewer's, the mix's ``frame``; cameras follow the mix's seeded
yaw path (``harness/cameras.py``).

The check: once the window has closed, frames drawn from the seed among those
kept (one in ``keep_every`` finished frames, from a seeded phase) are rendered
again by the plain reference (``reference/raster.py``) in float32, and each
served label is judged by the reference's logits at its pixel:

  * ``label_mismatch_share``: the largest share, over the frames checked, of
    pixels whose label's logit lies below the reference's best;
  * ``label_gap_max``: the widest such gap.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import cameras
from benchmark.reference import raster


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.cfg, self.mix = cell.config, cell.traffic
        self.frame = cell.traffic["frame"]
        self.kept = {}
        self.next_index = 0
        self.camera = None
        self.frame_fn = self.program_frame

    # ---- the system under test ---------------------------------------------
    def setup(self) -> None:
        from segsplat_tpu_torch.core.types import Camera, GaussianTable

        cfg, fr = self.cfg, self.frame
        s = self.cell.scene_module().draw(cfg, self.seed, self.dev)
        n = s["xyz"].shape[0]
        z = torch.zeros((n, 1, 3), device=self.dev)
        self.scene = s
        self.table = GaussianTable(
            xyz=s["xyz"], features_dc=z, features_rest=z, scaling=s["log_scales"],
            rotation=s["quats"], opacity=s["opacity_logit"],
            objects_dc=torch.zeros((n, 1, 16), device=self.dev),
            active=torch.ones(n, dtype=torch.bool, device=self.dev), active_sh_degree=0)
        self.logits = s["logits"]
        self.R = cameras.rotations(self.mix["path"], self.seed, int(self.mix["max_iterations"]),
                                   self.dev)
        f32 = dict(dtype=torch.float32, device=self.dev)
        T, fx, fy = (torch.zeros(3, **f32), torch.tensor(fr["fov_x"], **f32),
                     torch.tensor(fr["fov_y"], **f32))
        self.camera = lambda i: Camera(R=self.R[i], T=T, fov_x=fx, fov_y=fy,
                                       width=fr["width"], height=fr["height"])
        rng = np.random.default_rng([self.seed % 2 ** 64, 0xC4EC])
        self.keep_phase = int(rng.integers(self.mix["keep_every"]))
        self.check_rng = rng
        for i in range(int(self.mix["warmup"])):
            self.iterate(i)
        self.kept.clear()
        self.next_index = int(self.mix["warmup"])

    def program_frame(self, i: int):
        from segsplat_tpu_torch.render import render_semantics

        cfg = self.cfg
        cam = self.camera(i)
        t0 = time.perf_counter()
        sem = render_semantics(self.table, cam, self.logits,
                               max_tiles_per_axis=cfg["max_tiles_per_axis"],
                               max_per_tile=cfg["max_per_tile"], pair_cap=cfg["pair_cap"])
        t1 = time.perf_counter()
        labels = sem.argmax(0).cpu()
        return labels, t0, t1

    def iterate(self, i: int) -> dict:
        labels, t0, t1 = self.frame_fn(i)
        t2 = time.perf_counter()
        if (i + self.keep_phase) % self.mix["keep_every"] == 0:
            self.kept[i] = labels
        return {"call": t1 - t0, "frame": t2 - t0}

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def aside(self, i: int) -> None:
        pass

    # ---- the yardstick -----------------------------------------------------
    def _ref_inputs(self):
        s = self.scene
        scales = torch.exp(s["log_scales"])
        quats = s["quats"] / (torch.linalg.norm(s["quats"], dim=-1, keepdim=True) + 1e-12)
        opac = torch.sigmoid(s["opacity_logit"])[:, 0]
        return s["xyz"], scales, quats, opac, s["logits"]

    def _ref_cam(self, i: int):
        fr = self.frame
        return raster.pinhole(self.R[i], torch.zeros(3, device=self.dev), fr["fov_x"],
                              fr["fov_y"], fr["width"], fr["height"])

    def reference_image(self, i: int, blend_dtype=torch.float32) -> torch.Tensor:
        """The reference's logits [H, W, CH] of frame i."""
        raster.no_tf32()
        xyz, scales, quats, opac, logits = self._ref_inputs()
        bg = torch.zeros(logits.shape[1], device=self.dev)
        with torch.no_grad():
            return raster.render(xyz, scales, quats, opac, logits, bg, self._ref_cam(i),
                                 self.cfg["max_tiles_per_axis"], self.cfg["max_per_tile"],
                                 blend_dtype=blend_dtype)

    def work(self, traced) -> list:
        """K1's rows and passing pair-pixels for each traced frame."""
        xyz, scales, quats, opac, logits = self._ref_inputs()
        bg = torch.zeros(logits.shape[1], device=self.dev)
        out = []
        with torch.no_grad():
            for i in traced:
                w = {}
                raster.render(xyz, scales, quats, opac, logits, bg, self._ref_cam(i),
                              self.cfg["max_tiles_per_axis"], self.cfg["max_per_tile"],
                              work=w, image=False)
                w.update(payload_rows=w["pairs"] + self.cfg["max_per_tile"],
                         channels=logits.shape[1], gaussians=xyz.shape[0],
                         pixels=self.frame["width"] * self.frame["height"])
                out.append(w)
        return out

    def release(self) -> None:
        self.table = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """[(name, value, limit)] over frames drawn from the seed among those kept."""
        kept = sorted(self.kept)
        n = min(int(self.mix["check_frames"]), len(kept))
        picks = sorted(self.check_rng.choice(kept, size=n, replace=False)) if n else []
        share, gap = (float("nan"), float("nan")) if not picks else (0.0, 0.0)
        for i in picks:
            ref = self.reference_image(int(i))
            lab = self.kept[i].to(self.dev).long()
            if lab.shape != ref.shape[:2]:
                share, gap = float("inf"), float("inf")
                break
            best = ref.max(-1).values
            got = ref.gather(-1, lab.clamp(0, ref.shape[-1] - 1)[..., None])[..., 0]
            bad = (lab < 0) | (lab >= ref.shape[-1])
            d = torch.where(bad, torch.inf, best - got)
            share = max(share, float((d > 0).float().mean()))
            gap = max(gap, float(d.max()))
        lim = self.mix["limits"]
        return [("label_mismatch_share", share, lim["label_mismatch_share"]),
                ("label_gap_max", gap, lim["label_gap_max"])]


def plant(loop: Loop, fault: str):
    """Put a broken frame in the program's place, for the harness's tests and
    ``tools/readings.py``: ``control`` (the reference with its blend in
    bfloat16), ``half_batch`` (the lower half of each frame's labels left
    out) or ``altered_answer`` (one label of each frame changed where it is
    produced). Returns a function that undoes it."""
    program = loop.program_frame

    def control(i):
        t0 = time.perf_counter()
        ref = loop.reference_image(i, blend_dtype=torch.bfloat16)
        t1 = time.perf_counter()
        return ref.argmax(-1).cpu(), t0, t1

    def half_batch(i):
        labels, t0, t1 = program(i)
        labels = labels.clone()
        labels[labels.shape[0] // 2:] = 0
        return labels, t0, t1

    def altered_answer(i):
        labels, t0, t1 = program(i)
        labels = labels.clone()
        y, x = labels.shape[0] // 2, labels.shape[1] // 2
        labels[y, x] = (labels[y, x] + 1) % int(loop.cfg["channels"])
        return labels, t0, t1

    loop.frame_fn = {"control": control, "half_batch": half_batch,
                     "altered_answer": altered_answer}[fault]

    def undo():
        loop.frame_fn = program
    return undo


FAULTS = ("half_batch", "altered_answer")
