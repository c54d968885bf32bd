#!/usr/bin/env python
"""Per-image LSeg 512-D dense feature extraction on PyTorch/CUDA, the twin of
the repo's scripts/extract_lseg_features.py (after the reference's
script/extract_lseg_features.py:43-98): resize the shorter side to 360 with
PIL's bilinear filter, pad to a multiple of 32, run LSeg, and save the
[512, H, W] fp16 .npy of each image, cut back to its unpadded size.

    python -m segsplat_tpu_torch.extract_lseg_features --images IMAGES \\
        --out_dir FEATURES [--checkpoint demo_e200.ckpt] [--dtype bfloat16|float32] \\
        [--device cuda|cpu]

Without ``--checkpoint`` the net runs on seeded random weights, and the output
directory is stamped ``weights_source=random``: the lift and the query refuse
it unless told to accept it.
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from segsplat_tpu_torch.io.provenance import RANDOM, write_provenance
from segsplat_tpu_torch.models.lseg import COMPUTE_DTYPES, LSegModel, pad_to_multiple
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None) -> list:
    """Extract every image's features; returns the written .npy paths."""
    p = ArgumentParser()
    p.add_argument("--images", required=True, help="input image directory")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--checkpoint", default="",
                   help="LSeg torch checkpoint (demo_e200.ckpt); random-init weights "
                        "are used when absent (features are then NOT semantically "
                        "meaningful, logged and stamped)")
    p.add_argument("--short_side", type=int, default=360)
    p.add_argument("--batch", type=int, default=1,
                   help="kept for argument compatibility: only 1 is taken (images are "
                        "run one at a time)")
    p.add_argument("--dtype", default="bfloat16", choices=list(COMPUTE_DTYPES),
                   help="compute dtype of the products and convolutions")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) raises when no card is present")
    args = p.parse_args(argv)
    if args.batch != 1:
        p.error(f"--batch {args.batch}: images are run one at a time")
    device = require_device(args.device)

    state_dict = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        sd = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
        state_dict = sd.get("state_dict", sd)
        print(f"[INFO] loaded LSeg weights from {args.checkpoint}")
        weights_source = f"checkpoint:{os.path.basename(args.checkpoint)}"
    else:
        print("[WARN] no LSeg checkpoint — using random weights; extracted "
              "features will not be semantically meaningful (stamped "
              "weights_source=random; downstream stages refuse them unless "
              "--allow_random_weights)")
        weights_source = RANDOM
    model = LSegModel(state_dict=state_dict, compute_dtype=COMPUTE_DTYPES[args.dtype],
                      device=device)

    os.makedirs(args.out_dir, exist_ok=True)
    write_provenance(args.out_dir, weights_source, short_side=args.short_side,
                     dtype=args.dtype)
    files = sorted(sum((glob.glob(os.path.join(args.images, e))
                        for e in ("*.jpg", "*.jpeg", "*.png", "*.JPG")), []))
    if not files:
        raise RuntimeError(f"no images in {args.images}")
    written = []
    for f in files:
        img = Image.open(f).convert("RGB")
        w, h = img.size
        scale = args.short_side / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        arr, (oh, ow) = pad_to_multiple(np.asarray(img, np.float32) / 255.0, 32)
        x = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))[None]
        feats = model.features(x)[0, :, :oh, :ow]                  # [512, H, W]
        out = feats.to(torch.float16).cpu().numpy()
        name = os.path.splitext(os.path.basename(f))[0]
        path = os.path.join(args.out_dir, name + ".npy")
        np.save(path, out)
        written.append(path)
        print(f"[OK] {name}: {out.shape}")
    return written


if __name__ == "__main__":
    main()
