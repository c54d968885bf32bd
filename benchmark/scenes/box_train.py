"""A training scene drawn from the seed: the draw of
``scripts/perf_train.py:37-63`` (as ``segsplat_tpu_torch/perf_train.py:
train_scene`` keeps it), with its distributions:

  * points uniform in the box [-2, 2] × [-1.5, 1.5] × [2, 6] m, colours U(0, 1);
  * GT images U(0, 1) [3, H, W] and GT masks of ``mask_ids`` ids uniform a
    pixel, ``gt_views`` of each, held on the device;

and, for the step's own draws, the contrastive loss's pixel sample
(``contrast_samples`` pixels a view, uniform with repeats) and the codebook,
U(±1/√16) as the program initialises it. Drawn on the device with a
``torch.Generator`` seeded by ``--seed``, in a few large calls.
"""

from __future__ import annotations

import torch


def draw(config: dict, seed: int, device) -> dict:
    n, W, H = int(config["points"]), int(config["width"]), int(config["height"])
    F = int(config["gt_views"])
    g = torch.Generator(device).manual_seed(seed)
    kw = dict(device=device, generator=g)
    lo = torch.tensor([-2.0, -1.5, 2.0], device=device)
    size = torch.tensor([4.0, 3.0, 4.0], device=device)
    points = torch.rand((n, 3), **kw) * size + lo
    colors = torch.rand((n, 3), **kw)
    gt_images = torch.rand((F, 3, H, W), **kw)
    gt_masks = torch.randint(0, int(config["mask_ids"]), (F, H, W), dtype=torch.int32, **kw)
    idx = torch.randint(0, H * W, (F, int(config["contrast_samples"])), **kw)
    d = int(config["identity_channels"])
    code_book = (torch.rand((int(config["codebook_rows"]), d), **kw) * 2 - 1) / d ** 0.5
    return {"points": points, "colors": colors, "gt_images": gt_images, "gt_masks": gt_masks,
            "idx": idx, "code_book": code_book}
