"""Fill removed-object holes in training frames, the port's twin of
scripts/inpaint_images.py (the same flags, plus ``--device``): the
in-framework stand-in for the reference's vendored LaMa stage
(lama/prepare_pseudo_label.py:1-25, which copies LaMa's fills into
``images_inpaint_unseen/`` for the edit_object_inpaint finetune).

    python -m segsplat_tpu_torch.inpaint_images --images DIR --masks DIR --out DIR
        [--select_obj_id 3 7] [--dilate 12] [--method patch|pushpull]
        [--report_lpips] [--device cuda|cpu]

Masks are the training ``object_mask/`` id maps with ``--select_obj_id``, or
binary PNGs (> 127 = hole), matched to the images by file stem. The hole is
dilated by ``--dilate`` pixels (scipy's binary_dilation; the reference dilates
before LaMa so shadows and fringes are refilled too), then filled on the
device by PatchMatch texture synthesis (``--method patch``, the default,
``ops/inpaint_patch.py``; each frame seeded with the previous fill when the
sizes agree) or push–pull with diffusion (``pushpull``, ``ops/inpaint.py``).
``--report_lpips`` prints each fill's LPIPS against the original frame.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
from PIL import Image
from scipy.ndimage import binary_dilation

from segsplat_tpu_torch.convert import lpips_from_params
from segsplat_tpu_torch.eval.lpips import load_lpips, lpips
from segsplat_tpu_torch.ops.inpaint import inpaint_pushpull
from segsplat_tpu_torch.ops.inpaint_patch import inpaint_texture
from segsplat_tpu_torch.utils.system import require_device


def load_mask(path: str, select_ids) -> np.ndarray:
    m = np.array(Image.open(path))
    if m.ndim == 3:
        m = m[..., 0]
    if select_ids:
        return np.isin(m, np.asarray(select_ids))
    return m > 127


def dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    return binary_dilation(mask, iterations=radius) if radius > 0 else mask


def main(argv=None) -> int:
    p = ArgumentParser()
    p.add_argument("--images", required=True)
    p.add_argument("--masks", required=True,
                   help="dir of object_mask id maps or binary mask PNGs; "
                        "matched to images by basename stem")
    p.add_argument("--out", required=True)
    p.add_argument("--select_obj_id", type=int, nargs="*", default=None,
                   help="treat masks as id maps and fill these ids")
    p.add_argument("--dilate", type=int, default=12)
    p.add_argument("--smooth_iters", type=int, default=64)
    p.add_argument("--method", choices=("patch", "pushpull"), default="patch",
                   help="patch: texture-synthesizing PatchMatch voting; "
                        "pushpull: membrane (harmonic) fill only")
    p.add_argument("--report_lpips", action="store_true",
                   help="score each fill vs the ORIGINAL frame with LPIPS "
                        "(eval/lpips.py; stamped lins and backbone)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to fill; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)
    lp_model = None
    if args.report_lpips:
        lp_params = load_lpips(net="vgg")
        lp_model = lpips_from_params(lp_params).to(device)
        print(f"[INFO] lpips: lins={lp_params['lin_source']} "
              f"backbone={lp_params['backbone_source']}")

    os.makedirs(args.out, exist_ok=True)
    mask_by_stem = {os.path.splitext(f)[0]: os.path.join(args.masks, f)
                    for f in sorted(os.listdir(args.masks))}
    n = 0
    prev = None     # the previous patch fill: the next frame's seed (inpaint_sequence)
    for f in sorted(os.listdir(args.images)):
        stem = os.path.splitext(f)[0]
        if stem not in mask_by_stem:
            continue
        img = np.asarray(Image.open(os.path.join(args.images, f)).convert("RGB"),
                         np.float32) / 255.0
        hole = dilate(load_mask(mask_by_stem[stem], args.select_obj_id), args.dilate)
        if args.method == "patch":
            init = prev if prev is not None and prev.shape == img.shape else None
            out = inpaint_texture(img, hole, init_fill=init, device=device)
            prev = out
        else:
            out = inpaint_pushpull(img, hole, smooth_iters=args.smooth_iters,
                                   device=device).cpu().numpy()
        Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(args.out, f))
        if lp_model is not None:
            print(f"  {f}: lpips_vgg={float(lpips(img, out, lp_model, device=device)):.4f} "
                  f"hole={hole.mean():.3f}")
        n += 1
    print(f"[DONE] inpainted {n} frames -> {args.out}")
    return n


if __name__ == "__main__":
    main()
