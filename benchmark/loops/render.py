"""The render loop: stage 5's sweep, closed loop and back to back, as the
render CLI runs it, through the program's per-view products step
(``segsplat_tpu_torch.pipeline.render_semantics.semantic_view_products``).
Iteration i is view i mod ``views`` of the orbit: views are queued
``view_batch`` at a time and the host waits once a batch for its counters
(``render.render_semantics_many``); a view is done when its labels [H, W]
int32, fp16 logits [P, H, W] and float32 confidence [H, W] are NumPy arrays
on the host. A new sweep starts a new generator after the orbit's last view.
The CLI's writer (PNG encoders, matplotlib, the disk) is left out: it
measures the disk and the plotting library.

The check: the window's first view and every ``keep_every``-th view after a
phase drawn from the seed are kept (their products). Once the window has
closed, ``check_views`` of them, drawn from the seed, are rendered again by
the plain reference (``reference/render.py``) in float32, and

  * ``label_mismatch_share``: the largest share, over the views checked, of
    pixels whose label's reference logit lies below the reference's best;
  * ``label_gap_max``: the widest such gap;
  * ``logit_gap_max``: the largest |program fp16 − reference rounded to
    fp16| over the view's largest |reference|;
  * ``confidence_gap_max``: the largest |program − reference| confidence.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import raster
from benchmark.reference import render as reference


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.cfg, self.mix = cell.config, cell.traffic
        self.kept = {}
        self.next_index = 0
        self.table = self.views = None
        self.products = self.program_products

    # ---- the system under test ---------------------------------------------
    def setup(self) -> None:
        # first, so that a program without the products step fails at once
        from segsplat_tpu_torch.pipeline.render_semantics import semantic_view_products
        from segsplat_tpu_torch.core.types import Camera, GaussianTable

        self.semantic_view_products = semantic_view_products
        cfg, dev = self.cfg, self.dev
        s = self.cell.scene_module().draw(cfg, self.seed, dev)
        self.scene = s
        n = s["xyz"].shape[0]
        z = torch.zeros((n, 1, 3), device=dev)
        self.table = GaussianTable(
            xyz=s["xyz"], features_dc=z, features_rest=z, scaling=s["log_scales"],
            rotation=s["quats"], opacity=s["opacity_logit"],
            objects_dc=torch.zeros((n, 1, 16), device=dev),
            active=torch.ones(n, dtype=torch.bool, device=dev), active_sh_degree=0)
        f32 = dict(dtype=torch.float32, device=dev)
        fov_x, fov_y = (torch.tensor(f, **f32) for f in s["fov"])
        self.cameras = [Camera(R=s["R"][v], T=s["T"][v], fov_x=fov_x, fov_y=fov_y,
                               width=cfg["width"], height=cfg["height"])
                        for v in range(s["R"].shape[0])]
        rng = np.random.default_rng([self.seed % 2 ** 64, 0x5E7D])
        self.keep_phase = int(rng.integers(self.mix["keep_every"]))
        self.check_rng = rng
        warmup = int(self.mix["warmup"])
        for i in range(warmup):
            self.view(i)
        self.drain()
        self.next_index = warmup

    def program_products(self, start: int, stop=None, pair_cap=None):
        """The products step over the orbit's views ``start`` to ``stop``."""
        cfg = self.cfg
        return self.semantic_view_products(
            self.table, self.cameras[start:stop], self.scene["logits"],
            bg_value=cfg["bg_value"],
            backend="cuda", max_tiles_per_axis=cfg["max_tiles_per_axis"],
            max_per_tile=cfg["max_per_tile"],
            pair_cap=cfg["pair_cap"] if pair_cap is None else pair_cap,
            view_batch=cfg["view_batch"])

    def view(self, i: int):
        """View i's products, from the running sweep's generator."""
        v = i % len(self.cameras)
        if v == 0 or self.views is None:
            self.views = iter(self.products(v))
            self.first = v
        rec = next(self.views)
        if self.first + rec.index != v:
            raise RuntimeError(f"iteration {i} got the products of view "
                               f"{self.first + rec.index}, not {v}")
        return rec

    def iterate(self, i: int) -> dict:
        t0 = time.perf_counter()
        rec = self.view(i)
        t1 = time.perf_counter()
        j = i - self.next_index
        if j == 0 or (j % self.mix["keep_every"]) == self.keep_phase:
            self.kept[i] = rec
        return {"call": t1 - t0}

    def drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def aside(self, i: int) -> None:
        pass

    # ---- the yardstick -----------------------------------------------------
    def _ref(self, i: int):
        s, cfg = self.scene, self.cfg
        v = i % len(self.cameras)
        cam = raster.pinhole(s["R"][v], s["T"][v], s["fov"][0], s["fov"][1], cfg["width"],
                             cfg["height"])
        g = reference.gaussians(s["xyz"], s["log_scales"], s["quats"], s["opacity_logit"])
        return g, cam

    def reference_view(self, i: int, blend_dtype=torch.float32) -> torch.Tensor:
        """The reference's logits [P, H, W] of iteration i's view."""
        g, cam = self._ref(i)
        cfg = self.cfg
        return reference.view_logits(g, self.scene["logits"], cam, cfg["max_tiles_per_axis"],
                                     cfg["max_per_tile"], cfg["bg_value"],
                                     blend_dtype=blend_dtype)

    def work(self, traced) -> list:
        """Each traced view's counts (``reference.view_work``)."""
        cfg, out = self.cfg, []
        for i in traced:
            g, cam = self._ref(i)
            out.append(reference.view_work(g, self.scene["logits"], cam,
                                           cfg["max_tiles_per_axis"], cfg["max_per_tile"]))
        return out

    def release(self) -> None:
        self.table = self.views = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """[(name, value, limit)] over views drawn from the seed among those kept."""
        kept = sorted(self.kept)
        n = min(int(self.mix["check_views"]), len(kept))
        picks = sorted(self.check_rng.choice(kept, size=n, replace=False)) if n else []
        worst = [float("nan")] * 4 if not picks else [0.0] * 4
        for i in picks:
            got = compare(self.kept[int(i)], self.reference_view(int(i)))
            worst = [max(a, b) for a, b in zip(worst, got)]
        lim = self.mix["limits"]
        return [(name, v, lim[name]) for name, v in zip(NUMBERS, worst)]


NUMBERS = ("label_mismatch_share", "label_gap_max", "logit_gap_max", "confidence_gap_max")


def compare(rec, ref: torch.Tensor):
    """The four numbers of ``NUMBERS`` for one view's products ``rec``
    against the reference's logits ``ref`` [P, H, W] (the module
    docstring); inf where the shapes differ."""
    dev, P = ref.device, ref.shape[0]
    lab = torch.from_numpy(np.asarray(rec.labels)).to(dev).long()
    half = torch.from_numpy(np.asarray(rec.logits)).to(dev)
    conf = torch.from_numpy(np.asarray(rec.confidence)).to(dev)
    if lab.shape != ref.shape[1:] or half.shape != ref.shape or conf.shape != ref.shape[1:]:
        return (float("inf"),) * 4
    best = ref.max(0).values
    got = ref.gather(0, lab.clamp(0, P - 1)[None])[0]
    d = torch.where((lab < 0) | (lab >= P), torch.inf, best - got)
    scale = float(ref.abs().max())
    logit_gap = float((half.float() - ref.half().float()).abs().max())
    conf_gap = float((conf.double() - reference.confidence(ref)).abs().max())
    return (float((d > 0).float().mean()), float(d.max()),
            logit_gap / scale if scale > 0 else float("inf"), conf_gap)


def plant(loop: Loop, fault: str):
    """Put broken products in the program's place, for the harness's tests
    and ``tools/readings.py``, before set-up: ``control`` (the reference, its
    blend in bfloat16, with NumPy's argmax and the reference's confidence on
    its logits), ``pair_cap_3m`` (the program under the CLI's
    former default cap of 3 M pairs; on a view with fewer pairs, a cap of
    90 % of the view's own, so the cap always binds) or ``previous_view``
    (each view's record carries the products of the view queued before it).
    Returns a function that undoes it."""
    program = loop.products

    def control(start):
        from segsplat_tpu_torch.pipeline.render_semantics import ViewProducts

        for k in range(len(loop.cameras) - start):
            ref = loop.reference_view(start + k, blend_dtype=torch.bfloat16).cpu().numpy()
            yield ViewProducts(k, ref.argmax(0).astype(np.int32), ref.astype(np.float16),
                               reference.confidence(torch.from_numpy(ref)).float().numpy(),
                               0, 0)

    def pair_cap_3m(start):
        for v in range(start, len(loop.cameras)):
            pairs = next(loop.program_products(v, v + 1)).num_pairs
            cap = min(3_000_000, int(0.9 * pairs))
            yield next(loop.program_products(v, v + 1, cap))._replace(index=v - start)

    def previous_view(start):
        for rec in program(start):
            before = loop.previous or rec
            loop.previous = rec
            yield before._replace(index=rec.index)

    loop.previous = None
    loop.products = {"control": control, "pair_cap_3m": pair_cap_3m,
                     "previous_view": previous_view}[fault]

    def undo():
        loop.products = program
    return undo


FAULTS = ("pair_cap_3m", "previous_view")
