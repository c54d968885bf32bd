"""LERF-Masked segmentation inference, the port's twin of
scripts/render_lerf_mask.py (the same flags, plus ``--device``):

    python -m segsplat_tpu_torch.render_lerf_mask -m MODEL (--query_mask MASK.png
        | --query_text PROMPT --lseg_feat F.npy) [--device cuda|cpu]

Renders the 16 identity channels per view (K1 at 19 channels with the RGB on
the card), classifies them with the trained codebook, selects the class ids
whose frame-0 mask lies inside the query mask (IoA > ``--ioa_threshold``) and
writes each view's mask: the selected classes' largest softmax probability
> ``--softmax_threshold`` (the reference's render_lerf_mask_unified_lift.py:
46-134). The query mask is a PNG (``--query_mask``, which wins) or the text
grounding of frame-0 LSeg features (``--query_text``,
``pipeline/query.text_query_mask``), resized to the render with PIL's
NEAREST. The output directory carries the grounding's provenance stamp.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from segsplat_tpu_torch.io.artifacts import find_codebook, load_codebook
from segsplat_tpu_torch.io.dataset import resolution_scale_for
from segsplat_tpu_torch.io.provenance import (read_weights_source, require_untainted,
                                              write_provenance)
from segsplat_tpu_torch.pipeline.query import text_query_mask
from segsplat_tpu_torch.render import render
from segsplat_tpu_torch.scene import Scene, to_device_camera
from segsplat_tpu_torch.train.editing import select_obj_ioa
from segsplat_tpu_torch.utils.config import ModelParams, get_combined_args
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None):
    parser = ArgumentParser()
    ModelParams(parser, sentinel=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--classifier", default="",
                        help="classifier.npz codebook (defaults to the one next "
                             "to the loaded point cloud)")
    parser.add_argument("--query_mask", default="",
                        help="binary PNG mask of the queried object on view 0 "
                             "(the grounded-SAM output in the reference); "
                             "optional when --query_text is given")
    parser.add_argument("--query_text", default="",
                        help="text prompt, grounded in-framework against "
                             "frame-0 LSeg features (--lseg_feat/--lseg_dir)")
    parser.add_argument("--lseg_feat", default="",
                        help="frame-0 LSeg feature map .npy for --query_text")
    parser.add_argument("--lseg_dir", default="",
                        help="directory of per-view LSeg .npy maps; frame 0's "
                             "is matched by camera name")
    parser.add_argument("--relevancy_threshold", type=float, default=0.5)
    parser.add_argument("--ioa_threshold", type=float, default=0.7)
    parser.add_argument("--softmax_threshold", type=float, default=0.2)
    parser.add_argument("--out_name", default="test_mask")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="accept LSeg features tainted "
                             "weights_source=random (taint propagates to the "
                             "mask output dir)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to render; cuda raises when no GPU is present")
    args = get_combined_args(parser, argv)
    device = require_device(args.device)

    scene = Scene(args.source_path, args.model_path, images=args.images,
                  eval_split=args.eval, shuffle=False,
                  load_iteration=args.iteration, device=device)
    cls_path = args.classifier or find_codebook(args.model_path, scene.loaded_iter)
    code_book = torch.as_tensor(load_codebook(cls_path), device=device)   # [256, 16]

    cams = scene.get_test_cameras() or scene.get_train_cameras()
    scale = resolution_scale_for(cams[0].width, cams[0].height, args.resolution)
    dcams = [to_device_camera(c, scale, device=device) for c in cams]
    bg = torch.zeros((3,), device=device)

    @torch.no_grad()
    def view_logits(cam):
        obj = render(scene.gaussians, cam, bg)["render_object"]
        return torch.einsum("kd,dhw->khw", code_book, obj)               # [256, H, W]

    # frame 0: the class ids under the query mask (:76-78)
    pred0 = torch.argmax(view_logits(dcams[0]), dim=0).cpu().numpy()
    # grounding provenance: random-weight LSeg features must not silently
    # become LERF eval numbers; the stamp follows the masks
    grounding_source = "grounding:precomputed_mask"
    if args.query_mask:
        qmask = np.asarray(Image.open(args.query_mask).convert("L").resize(
            (pred0.shape[1], pred0.shape[0]), Image.NEAREST)) > 128
    elif args.query_text:
        feat_path = args.lseg_feat
        if not feat_path:
            if not args.lseg_dir:
                raise SystemExit("--query_text needs --lseg_feat or --lseg_dir")
            feat_path = os.path.join(args.lseg_dir, f"{cams[0].image_name}.npy")
        grounding_source = read_weights_source(feat_path)
        require_untainted(grounding_source, args.allow_random_weights,
                          f"LSeg features {feat_path}")
        fmap = np.load(feat_path).astype(np.float32)                      # [C, h, w]
        qsmall = text_query_mask(fmap, args.query_text,
                                 threshold=args.relevancy_threshold,
                                 channels_first=True, device=device)
        qmask = np.asarray(Image.fromarray(qsmall.astype(np.uint8) * 255).resize(
            (pred0.shape[1], pred0.shape[0]), Image.NEAREST)) > 128
        print(f"[INFO] grounded '{args.query_text}' → {int(qmask.sum())} px on frame 0")
    else:
        raise SystemExit("pass --query_mask or --query_text")
    ids = select_obj_ioa(pred0, qmask, args.ioa_threshold)
    print(f"[INFO] selected object ids: {ids}")

    out_dir = os.path.join(args.model_path, args.out_name, f"ours_{scene.loaded_iter}")
    os.makedirs(out_dir, exist_ok=True)
    write_provenance(out_dir,
                     grounding_source if grounding_source is not None
                     else "grounding:unstamped_lseg_features",
                     stage="render_lerf_mask")
    for cam, info in zip(dcams, cams):
        logits = view_logits(cam)
        if ids:
            prob = torch.softmax(logits, dim=0)                           # [256, H, W]
            sel = prob[torch.as_tensor(ids, device=device)].amax(dim=0).cpu().numpy()
        else:
            sel = np.zeros(pred0.shape, np.float32)
        mask = (sel > args.softmax_threshold).astype(np.uint8) * 255
        Image.fromarray(mask).save(os.path.join(out_dir, f"{info.image_name}.png"))
    print(f"[DONE] masks → {out_dir}")


if __name__ == "__main__":
    main()
