"""The Unified-Lift train loop: the step of
``segsplat_tpu_torch.train.trainer.make_train_step(cfg, raster_kw)``, back to
back. Step i takes camera i of the mix's seeded yaw path and the
(i mod ``gt_views``)-th GT image, mask and contrastive pixel sample, all held
on the device.

Set-up builds one training state from the seed (``init_table_from_pcd``,
``init_state`` with the drawn codebook), drives it through its first
``check_steps`` steps by the window's own call and feed, and hands that same
state to the window. Around those steps it reads each step's total loss, each
leaf's first gradient from Adam's first moment after step 1 (m₁ = (1 − β₁)·g)
and each leaf's change after the last of them, before the next step moves it.

Inside the window, one step drawn from the seed among its first
``probe_within`` (the probe) is read too: just before it the loop keeps
every leaf and its Adam moments, and again just after it; the step's
gradient is (m_after − β₁·m_before)/(1 − β₁).

The check: the plain reference (``reference/train.py``) follows the set-up's
steps from the same inputs, and takes the probe's step from the state kept
before it (the one input the program made), and

  * ``loss_gap``: the largest |loss − reference| / |reference| over the steps;
  * ``grad_gap``, ``change_gap``: over the leaves, the largest
    |‖program‖ − ‖reference‖| / max(‖reference leaf‖, median leaf's ‖reference‖)
    of the first gradient and of the change; a leaf whose reference gradient
    is under a thousandth of the median leaf's is left out of both (its
    moves are rounding);
  * ``window_loss_gap``, ``window_grad_gap``, ``window_change_gap``: the same
    of the probe's step. A probe the window never reached reads infinite.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark.harness import cameras
from benchmark.reference import raster
from benchmark.reference import train as ref_train

BETA1 = 0.9


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.cfg, self.mix = cell.config, cell.traffic
        self.next_index = 0
        self.snapshots = {}
        self.readout = {"loss": [], "grad1": {}, "change": {}}
        self.probe, self.before, self.after = None, None, None
        self.make_step = self.program_step

    # ---- the system under test ---------------------------------------------
    def program_step(self):
        """(step(i) → metrics, {leaf: tensor}, {leaf: Adam state}) of the program."""
        from segsplat_tpu_torch.core.types import Camera
        from segsplat_tpu_torch.train.trainer import (OptimizationConfig, init_state,
                                                      init_table_from_pcd, make_train_step)

        cfg, s = self.cfg, self.scene
        table = init_table_from_pcd(s["points"].cpu().numpy(), s["colors"].cpu().numpy(),
                                    cfg["capacity"], max_sh_degree=cfg["sh_degree"],
                                    seed=self.identity_seed, device=self.dev)
        ocfg = OptimizationConfig(num_classes=cfg["num_classes"])
        state = init_state(table, ocfg, spatial_lr_scale=cfg["spatial_lr_scale"],
                           code_book=s["code_book"])
        step = make_train_step(ocfg, dict(max_tiles_per_axis=cfg["max_tiles_per_axis"],
                                          max_per_tile=cfg["max_per_tile"], backend="cuda",
                                          pair_cap=cfg["pair_cap"]))
        f32 = dict(dtype=torch.float32, device=self.dev)
        T, fx, fy = (torch.zeros(3, **f32), torch.tensor(cfg["fov_x"], **f32),
                     torch.tensor(cfg["fov_y"], **f32))
        bg = torch.zeros(3, **f32)
        F = int(cfg["gt_views"])

        def run(i):
            cam = Camera(R=self.R[i], T=T, fov_x=fx, fov_y=fy, width=cfg["width"],
                         height=cfg["height"])
            return step(state, cam, s["gt_images"][i % F], s["gt_masks"][i % F], bg,
                        idx=s["idx"][i % F])

        leaves = {k: getattr(table, k) for k in ref_train.LEAVES if k != "code_book"}
        leaves["code_book"] = state.code_book
        opt_state = lambda p: (state.cls_opt if p is state.code_book else state.gauss_opt).state[p]
        self.state = state
        return run, leaves, opt_state

    def setup(self) -> None:
        cfg = self.cfg
        self.scene = self.cell.scene_module().draw(cfg, self.seed, self.dev)
        self.identity_seed = self.seed % 2 ** 64
        self.R = cameras.rotations(self.mix["path"], self.seed, int(self.mix["max_iterations"]),
                                   self.dev)
        self.step, self.leaves, self.opt_state = self.make_step()
        start = {k: v.detach().clone() for k, v in self.leaves.items()}
        n_check = int(self.mix["check_steps"])
        losses = []
        for i in range(n_check):
            losses.append(self.step(i)["total"])
            if i == 0:
                for k, p in self.leaves.items():
                    m = self.opt_state(p).get("exp_avg")
                    g = torch.zeros_like(p) if m is None else m / (1 - BETA1)
                    self.readout["grad1"][k] = float(torch.linalg.norm(g.double()))
        for k, p in self.leaves.items():
            self.readout["change"][k] = float(torch.linalg.norm((p.detach() - start[k]).double()))
        self.readout["loss"] = [float(x) for x in losses]
        del start
        for i in range(n_check, n_check + int(self.mix["warmup"])):
            self.step(i)
        self.drain()
        self.next_index = n_check + int(self.mix["warmup"])
        rng = np.random.default_rng([self.seed % 2 ** 64, 0x9B0E])
        self.probe = self.next_index + int(rng.integers(int(self.mix["probe_within"])))

    def kept(self) -> dict:
        """Every leaf and both its Adam moments (zero where the optimizer holds
        none yet), copied."""
        out = {"params": {}, "m": {}, "v": {}}
        for k, p in self.leaves.items():
            st = self.opt_state(p)
            out["params"][k] = p.detach().clone()
            for key, name in (("exp_avg", "m"), ("exp_avg_sq", "v")):
                out[name][k] = (st[key].detach().clone() if key in st
                                else torch.zeros_like(p.detach()))
        return out

    def iterate(self, i: int) -> dict:
        t0 = time.perf_counter()
        if i != self.probe:
            self.step(i)
        else:
            self.before = self.kept()
            self.probe_loss = self.step(i)["total"]
            self.after = self.kept()
        return {"call": time.perf_counter() - t0}

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def aside(self, i: int) -> None:
        """The geometry step i reads, kept for the work counts."""
        self.snapshots[i] = {k: self.leaves[k].detach().clone()
                             for k in ("xyz", "scaling", "rotation", "opacity")}

    # ---- the yardstick -----------------------------------------------------
    def work(self, traced) -> list:
        """K1's and K2's rows and passing pair-pixels for each traced step, on
        the geometry that step read."""
        cfg = self.cfg
        n = int(cfg["points"])
        active = torch.arange(cfg["capacity"], device=self.dev) < n
        out = []
        with torch.no_grad():
            for i in traced:
                g = self.snapshots.pop(i)
                rot = g["rotation"] / (torch.linalg.norm(g["rotation"], dim=-1, keepdim=True)
                                       + 1e-12)
                opac = torch.sigmoid(g["opacity"])[:, 0] * active.float()
                cam = raster.pinhole(self.R[i], torch.zeros(3, device=self.dev), cfg["fov_x"],
                                     cfg["fov_y"], cfg["width"], cfg["height"])
                w = {}
                raster.render(g["xyz"], torch.exp(g["scaling"]), rot, opac,
                              torch.zeros((opac.shape[0], 19), device=self.dev),
                              torch.zeros(19, device=self.dev), cam, cfg["max_tiles_per_axis"],
                              cfg["max_per_tile"], work=w, image=False)
                w.update(payload_rows=w["pairs"] + cfg["max_per_tile"],
                         channels=3 + int(cfg["identity_channels"]), gaussians=cfg["capacity"],
                         pixels=cfg["width"] * cfg["height"])
                out.append(w)
        return out

    def release(self) -> None:
        self.step = self.leaves = self.state = self.opt_state = None
        self.snapshots.clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self):
        s, F = self.scene, int(self.cfg["gt_views"])
        inputs = {"points": s["points"].cpu().numpy(), "colors": s["colors"].cpu().numpy(),
                  "identity_seed": self.identity_seed, "code_book": s["code_book"]}
        feed = lambda i: (self.R[i], s["gt_images"][i % F], s["gt_masks"][i % F],
                          s["idx"][i % F])
        return inputs, feed

    def probe_readout(self) -> dict:
        """The probe's loss, each leaf's gradient and change, as the reference's."""
        b, a = self.before, self.after
        return {"loss": [float(self.probe_loss)],
                "grad1": {k: float(torch.linalg.norm(((a["m"][k] - BETA1 * b["m"][k])
                                                      / (1 - BETA1)).double()))
                          for k in b["params"]},
                "change": {k: float(torch.linalg.norm((a["params"][k]
                                                       - b["params"][k]).double()))
                           for k in b["params"]}}

    def check(self) -> list:
        inputs, feed = self.reference_inputs()
        lim = self.mix["limits"]
        ref = ref_train.run(inputs, self.cfg, steps=int(self.mix["check_steps"]), feed=feed)
        out = compare(self.readout, ref, lim)
        if self.after is None:
            gaps = [float("inf")] * 3
        else:
            got = self.probe_readout()
            ref = ref_train.resume(inputs, self.cfg, dict(self.before, t=self.probe), feed)
            gaps = [v for _, v, _ in compare(got, ref, lim)]
        return out + [("window_" + n, v, lim["window_" + n])
                      for (n, _, _), v in zip(out, gaps)]


def compare(got: dict, ref: dict, limits: dict) -> list:
    """[(name, value, limit)] of a readout against the reference's."""
    if len(got["loss"]) != len(ref["loss"]):
        loss_gap = float("inf")
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g_ref = ref["grad1"]
    med = statistics.median(g_ref.values())
    leaves = [k for k in g_ref if g_ref[k] >= 1e-3 * med]

    def worst(name):
        scale = statistics.median(ref[name][k] for k in leaves)
        return max(abs(got[name].get(k, float("inf")) - ref[name][k]) / max(ref[name][k], scale)
                   for k in leaves)

    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", worst("grad1"), limits["grad_gap"]),
            ("change_gap", worst("change"), limits["change_gap"])]


def plant(loop: Loop, fault: str):
    """Put a broken step in the program's place, for the harness's tests and
    ``tools/readings.py``: ``control`` (the reference's step with its blend in
    bfloat16), ``state_unchanged`` (the program's updates skipped) or
    ``half_batch`` (the L1 term's mean over the upper half of the rows only).
    Returns a function that undoes it."""
    from segsplat_tpu_torch.train import losses, trainer

    if fault == "control":
        def control_step():
            inputs, feed = loop.reference_inputs()
            st = ref_train.Stepper(inputs, loop.cfg, feed, blend_dtype=torch.bfloat16)
            by_id = {id(v): k for k, v in st.p.items()}
            return st.step, st.p, lambda p: {"exp_avg": st.state[by_id[id(p)]]["m"],
                                             "exp_avg_sq": st.state[by_id[id(p)]]["v"]}
        loop.make_step = control_step
        return lambda: setattr(loop, "make_step", loop.program_step)
    if fault == "state_unchanged":
        saved = trainer.apply_updates
        trainer.apply_updates = lambda state: None
        return lambda: setattr(trainer, "apply_updates", saved)
    if fault == "half_batch":
        saved = losses.l1_loss
        losses.l1_loss = lambda pred, gt: saved(pred[:, :pred.shape[1] // 2],
                                                gt[:, :gt.shape[1] // 2])
        return lambda: setattr(losses, "l1_loss", saved)
    raise KeyError(fault)


FAULTS = ("state_unchanged", "half_batch")
