#!/usr/bin/env python
"""Per-view logit confidence map, the twin of the repo's
scripts/logit_confidence_map.py with the same flags (the reference's
voxel_to_gaussian/logit_confidence_map.py:6-25): confidence = top-1 − top-2
softmax probability over the prompt axis, a PNG with a colour bar. Host numpy,
no ``--device``.

    python -m segsplat_tpu_torch.logit_confidence_map --logits view.npy --out conf.png
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.pipeline.render_semantics import (confidence_from_logits,
                                                          save_confidence_png)


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--logits", required=True, help="[P,H,W] .npy logits")
    p.add_argument("--out", required=True, help="output PNG path")
    args = p.parse_args(argv)

    logits = np.load(args.logits).astype(np.float32)
    conf = confidence_from_logits(logits, axis=0)
    save_confidence_png(args.out, conf)
    print(f"[DONE] confidence map → {args.out} "
          f"(mean {conf.mean():.3f}, min {conf.min():.3f}, max {conf.max():.3f})")
    return conf


if __name__ == "__main__":
    main()
