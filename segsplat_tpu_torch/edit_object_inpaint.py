"""Object inpainting on a trained scene, the port's twin of
scripts/edit_object_inpaint.py (the same flags, plus ``--device``):

    python -m segsplat_tpu_torch.edit_object_inpaint -m MODEL --select_obj_id 3
        [--images images_inpaint_unseen] [--finetune_iters 200] [--device cuda|cpu]

The reference's edit_object_inpaint workflow (edit_object_inpaint.sh; the .py
it calls is absent upstream): remove the selected object's Gaussians, seed
replacements from the surrounding geometry (``train/editing.inpaint_setup``),
then finetune only the new rows against the inpainted frames (``--images``,
from LaMa as in the reference or from ``segsplat_tpu_torch.inpaint_images``)
with the gradient mask of gaussian_model.py:187-205.

The finetune is one ``torch.optim.Adam`` (lr 1.6e-4, eps 1e-15) over the seven
table fields, as the JAX script's ``optax.adam`` over ``table_params``; its
loss is 0.8·L1 + 0.2·(1 − SSIM) of the RGB render, through the kernels (K1
forward, K2 backward, 19 channels) on the card and the dense blend on the CPU;
the views are drawn by numpy's ``default_rng(0)``. Each part of a step runs in
a profiler range (``finetune.render``, ``.loss``, ``.backward``, ``.adam``).
"""

from __future__ import annotations

import dataclasses
from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.core.types import Camera, GaussianTable
from segsplat_tpu_torch.io.artifacts import find_codebook, load_codebook
from segsplat_tpu_torch.io.dataset import resolution_scale_for
from segsplat_tpu_torch.render import raster_backend, render
from segsplat_tpu_torch.scene import Scene, to_device_camera
from segsplat_tpu_torch.train import losses as L
from segsplat_tpu_torch.train.densify import PARAM_FIELDS
from segsplat_tpu_torch.train.editing import (finetune_grad_mask, inpaint_setup,
                                              mask3d_from_classes)
from segsplat_tpu_torch.utils.config import ModelParams, get_combined_args
from segsplat_tpu_torch.utils.profiling import annotate
from segsplat_tpu_torch.utils.system import require_device

class MaskedFinetune:
    """Photometric finetune of the rows ``trainable`` of ``table``: leaf copies
    of the seven fields under one Adam, every other row's gradient masked to 0
    and the identity features' zeroed before each update. ``step`` is one
    iteration; its parts (``render``, ``loss``, ``backward``, ``update``) are
    public so that each can be timed alone."""

    def __init__(self, table: GaussianTable, trainable: np.ndarray, backend: str):
        self.base = table
        self.params = {f: getattr(table, f).detach().clone().requires_grad_(True)
                       for f in PARAM_FIELDS}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=1.6e-4, eps=1e-15)
        self.mask_fn = finetune_grad_mask(trainable)
        self.backend = backend
        self.bg = torch.zeros((3,), device=table.xyz.device)

    def table(self) -> GaussianTable:
        return dataclasses.replace(self.base, **self.params)

    def render(self, cam: Camera) -> torch.Tensor:
        with annotate("finetune.render"):
            return render(self.table(), cam, self.bg, backend=self.backend)["render"]

    def loss(self, image: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        with annotate("finetune.loss"):
            return 0.8 * L.l1_loss(image, gt) + 0.2 * (1.0 - L.ssim(image, gt))

    def backward(self, loss: torch.Tensor) -> None:
        with annotate("finetune.backward"):
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.mask_fn(self.params)

    def update(self) -> None:
        with annotate("finetune.adam"):
            self.opt.step()

    def step(self, cam: Camera, gt: torch.Tensor) -> torch.Tensor:
        loss = self.loss(self.render(cam), gt)
        self.backward(loss)
        self.update()
        return loss.detach()


def finetune(scene: Scene, table: GaussianTable, new_rows: np.ndarray, iters: int,
             resolution: int = -1, device: str | torch.device = "cuda"):
    """``iters`` masked finetune steps on views drawn by ``default_rng(0)``.
    Returns (the finetuned table, the losses [iters] on the host)."""
    device = require_device(device)
    cams = scene.get_train_cameras()
    scale = resolution_scale_for(cams[0].width, cams[0].height, resolution)
    ft = MaskedFinetune(table, new_rows, raster_backend(device))
    rng = np.random.default_rng(0)
    losses = []
    for it in range(iters):
        ci = int(rng.integers(0, len(cams)))
        cam = to_device_camera(cams[ci], scale, device=device)
        gt = torch.from_numpy(np.ascontiguousarray(
            np.transpose(cams[ci].load_image(scale), (2, 0, 1)))).to(device)
        losses.append(ft.step(cam, gt))
        if it % 50 == 0:
            print(f"  finetune {it}: loss {float(losses[-1]):.4f}")
    host = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
    return dataclasses.replace(table, **{f: p.detach() for f, p in ft.params.items()}), host


def main(argv=None) -> str:
    parser = ArgumentParser()
    ModelParams(parser, sentinel=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--select_obj_id", type=int, nargs="+", required=True)
    parser.add_argument("--classifier", default="")
    parser.add_argument("--finetune_iters", type=int, default=0,
                        help="masked finetune steps against --images "
                             "(expects LaMa-inpainted images, e.g. "
                             "images_inpaint_unseen/)")
    parser.add_argument("--out_iteration", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to finetune; cuda raises when no GPU is present")
    args = get_combined_args(parser, argv)
    device = require_device(args.device)

    scene = Scene(args.source_path, args.model_path, images=args.images,
                  shuffle=False, load_iteration=args.iteration, device=device)
    code_book = load_codebook(args.classifier or find_codebook(args.model_path,
                                                               scene.loaded_iter))
    mask = mask3d_from_classes(scene.gaussians, code_book, args.select_obj_id)
    print(f"[INFO] inpainting over {int(mask.sum())} removed gaussians")
    edited, new_rows = inpaint_setup(scene.gaussians, mask)
    print(f"[INFO] seeded {int(new_rows.sum())} replacement gaussians")

    if args.finetune_iters > 0:
        edited, _ = finetune(scene, edited, new_rows, args.finetune_iters,
                             resolution=args.resolution, device=device)
    path = scene.save(args.out_iteration or (scene.loaded_iter + 1), edited)
    print(f"[DONE] → {path}")
    return path


if __name__ == "__main__":
    main()
