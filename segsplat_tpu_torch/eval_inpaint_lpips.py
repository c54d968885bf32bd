"""Perceptual scoring of the two inpainters, the port's twin of
scripts/eval_inpaint_lpips.py (the same flags; ``--platform`` becomes
``--device``, and the images to crop are named by ``--images``):

    python -m segsplat_tpu_torch.eval_inpaint_lpips --images A.png B.jpg ...
        [--size 192] [--device cuda|cpu]

The reference judges inpainting by LPIPS (lama/saicinpainting/evaluation/
losses/lpips.py). This scores push–pull with diffusion (``ops/inpaint.py``),
PatchMatch texture synthesis (``ops/inpaint_patch.py``) and three known-bad
controls (mean fill, noise fill, an unrelated crop pasted into the hole) on
textured crops of natural images (the JAX script crops the reference tree's
photograph and figure renders; none is committed here, so the caller names
them), under
LaMa-style irregular-stroke and rectangle masks
(lama/saicinpainting/training/data/masks.py): hole MAE, SSIM
(``train/losses.ssim``) and LPIPS vgg and alex, whose stamps (lins, backbone)
go into the JSON. The controls calibrate the instrument's low end: a bad fill
must score well above both methods.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from segsplat_tpu_torch.convert import lpips_from_params
from segsplat_tpu_torch.eval.lpips import load_lpips, lpips
from segsplat_tpu_torch.ops.inpaint import inpaint_pushpull
from segsplat_tpu_torch.ops.inpaint_patch import inpaint_texture
from segsplat_tpu_torch.train.losses import ssim
from segsplat_tpu_torch.utils.system import require_device

CONTROLS = ("meanfill", "noisefill", "wrongtex")


def natural_crops(size: int, per_image: int, seed: int = 0, paths=()) -> list:
    """Textured [size, size, 3] float crops in [0, 1] of the images at
    ``paths``; near-flat crops (std < 0.04) are rejected. Returns
    [(file name, crop)]."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    crops = []
    for p in paths:
        if not os.path.exists(p):
            continue
        arr = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        h, w = arr.shape[:2]
        if min(h, w) <= size:
            continue
        got, tries = 0, 0
        while got < per_image and tries < 200:
            tries += 1
            y = int(rng.integers(0, h - size))
            x = int(rng.integers(0, w - size))
            c = arr[y:y + size, x:x + size]
            if c.std() < 0.04:
                continue
            crops.append((os.path.basename(p), c))
            got += 1
    return crops


def stroke_mask(h: int, w: int, rng, strokes: int = 3) -> np.ndarray:
    """Irregular thick-stroke hole (LaMa's irregular line masks,
    saicinpainting/training/data/masks.py)."""
    m = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(strokes):
        y, x = rng.uniform(0.2 * h, 0.8 * h), rng.uniform(0.2 * w, 0.8 * w)
        ang = rng.uniform(0, 2 * np.pi)
        for _seg in range(int(rng.integers(2, 5))):
            ln = rng.uniform(0.15, 0.35) * min(h, w)
            y2, x2 = y + ln * np.sin(ang), x + ln * np.cos(ang)
            n = max(int(ln), 2)
            ys = np.linspace(y, y2, n)
            xs = np.linspace(x, x2, n)
            r = rng.uniform(0.02, 0.045) * min(h, w)
            for cy, cx in zip(ys, xs):
                m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            y, x = y2, x2
            ang += rng.uniform(-1.0, 1.0)
    return m


def rect_mask(h: int, w: int, rng) -> np.ndarray:
    m = np.zeros((h, w), bool)
    bh = int(rng.uniform(0.15, 0.3) * h)
    bw = int(rng.uniform(0.15, 0.3) * w)
    y = int(rng.integers(h // 8, h - bh - h // 8))
    x = int(rng.integers(w // 8, w - bw - w // 8))
    m[y:y + bh, x:x + bw] = True
    return m


def _ssim(a: np.ndarray, b: np.ndarray, device) -> float:
    chw = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1))).to(device)
    return float(ssim(chw(a), chw(b)))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--images", nargs="+", required=True,
                   help="natural images to crop (the JAX script's REF_IMAGES)")
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--per_image", type=int, default=3)
    p.add_argument("--masks_per_crop", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_json", default="inpaint_lpips_eval.json")
    p.add_argument("--patch_iters", type=int, default=6)
    p.add_argument("--methods", nargs="+",
                   default=["pushpull", "patch", *CONTROLS],
                   help="known-bad controls (meanfill/noisefill/wrongtex) "
                        "calibrate the instrument's low end: bad fills must "
                        "score well above both methods on the same crops")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to fill and score; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)

    crops = natural_crops(args.size, args.per_image, args.seed, paths=args.images)
    if not crops:
        raise SystemExit("no textured crops in --images")
    print(f"[INFO] {len(crops)} natural crops @ {args.size}px")
    params = {net: load_lpips(net=net) for net in ("vgg", "alex")}
    models = {net: lpips_from_params(pr).to(device) for net, pr in params.items()}
    for net, pr in params.items():
        print(f"[INFO] lpips/{net}: lins={pr['lin_source']} "
              f"backbone={pr['backbone_source']}")

    rng = np.random.default_rng(args.seed + 1)
    rows = []
    for ci, (src, img) in enumerate(crops):
        for mi in range(args.masks_per_crop):
            mask = (stroke_mask(args.size, args.size, rng) if mi % 2 == 0
                    else rect_mask(args.size, args.size, rng))
            for method in args.methods:
                if method == "pushpull":
                    out = inpaint_pushpull(img, mask, device=device).cpu().numpy()
                elif method == "patch":
                    out = inpaint_texture(img, mask, pm_iters=args.patch_iters, seed=args.seed,
                                          device=device)
                elif method == "meanfill":
                    out = img.copy()
                    out[mask] = img[~mask].mean(axis=0)
                elif method == "noisefill":
                    crng = np.random.default_rng(args.seed + 7 * ci + mi)
                    out = img.copy()
                    out[mask] = crng.uniform(size=(int(mask.sum()), 3)).astype(np.float32)
                elif method == "wrongtex":
                    # an unrelated natural crop pasted into the hole: the
                    # plausible-but-wrong failure a fill can produce
                    other = crops[(ci + len(crops) // 2) % len(crops)][1]
                    out = img.copy()
                    out[mask] = other[mask]
                else:
                    raise SystemExit(f"unknown method {method!r}")
                hole = mask[..., None]
                mae = float(np.abs((out - img) * hole).sum() / max(hole.sum() * 3, 1))
                row = {
                    "crop": f"{src}#{ci}", "mask": ["stroke", "rect"][mi % 2],
                    "hole_frac": float(mask.mean()), "method": method,
                    "mae_hole": mae, "ssim": _ssim(out, img, device),
                    "lpips_vgg": float(lpips(img, out, models["vgg"], device=device)),
                    "lpips_alex": float(lpips(img, out, models["alex"], device=device)),
                }
                rows.append(row)
                print(f"  {row['crop']:24s} {row['mask']:6s} {method:9s} "
                      f"mae={mae:.4f} ssim={row['ssim']:.4f} "
                      f"lpips_vgg={row['lpips_vgg']:.4f} "
                      f"lpips_alex={row['lpips_alex']:.4f}")

    summary = {}
    for method in args.methods:
        rs = [r for r in rows if r["method"] == method]
        summary[method] = {k: float(np.mean([r[k] for r in rs]))
                           for k in ("mae_hole", "ssim", "lpips_vgg", "lpips_alex")}
        s = summary[method]
        print(f"[MEAN] {method:9s} mae={s['mae_hole']:.4f} ssim={s['ssim']:.4f} "
              f"lpips_vgg={s['lpips_vgg']:.4f} lpips_alex={s['lpips_alex']:.4f}")
    # the instrument's range: the worst real method against the best control
    controls = [m for m in args.methods if m in CONTROLS]
    real = [m for m in args.methods if m not in controls]
    dynamic_range = {}
    if controls and real:
        for net in ("lpips_vgg", "lpips_alex"):
            worst_real = max(summary[m][net] for m in real)
            best_control = min(summary[m][net] for m in controls)
            dynamic_range[net] = {
                "worst_real_method": worst_real, "best_control": best_control,
                "separation_x": round(best_control / max(worst_real, 1e-9), 1)}
            print(f"[RANGE] {net}: worst real {worst_real:.4f} vs best control "
                  f"{best_control:.4f} → separation {dynamic_range[net]['separation_x']}x")

    out = {"rows": rows, "summary": summary, "dynamic_range": dynamic_range,
           "lpips_provenance": {n: {"lins": params[n]["lin_source"],
                                    "backbone": params[n]["backbone_source"]}
                                for n in params},
           "size": args.size, "seed": args.seed}
    with open(args.out_json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[DONE] → {args.out_json}")
    return out


if __name__ == "__main__":
    main()
