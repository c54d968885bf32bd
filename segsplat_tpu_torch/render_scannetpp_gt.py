"""Render ScanNet++ GT label maps from the annotated mesh, the port's twin of
scripts/render_scannetpp_gt.py (the same flags, plus ``--device``): the GT
half of the mIoU protocol (README.md:101-103, "GT label maps rendered from the
annotated mesh"; the reference's debug_checks_scripts/render_scannetpp.py).

For every camera of the stage camera-params JSON the annotated mesh is
z-buffered into a per-pixel label map (``ops/mesh_raster.py``: tile binning,
barycentric coverage, depth argmin) on ``--device`` and written as
``{name}_labels.pt``, which ``eval_scannetpp`` reads as ``--gt_dir``.

    python -m segsplat_tpu_torch.render_scannetpp_gt --mesh mesh_annotated.ply \
        --camera_params camera_params.json --image_size 1752 1168 \
        --downsample 0.5 --out_dir gt_labels/ [--device cuda|cpu]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from segsplat_tpu_torch.io.artifacts import save_label_map
from segsplat_tpu_torch.io.ply import read_ply
from segsplat_tpu_torch.ops.mesh_raster import MISS_LABEL, rasterize_mesh_labels_chunked
from segsplat_tpu_torch.pipeline.lift_features import load_camera_json
from segsplat_tpu_torch.utils.palette import bit_shuffle_palette
from segsplat_tpu_torch.utils.system import require_device

LABEL_PROPS = ("label", "semantic_label", "objectId", "obj_id", "class",
               "scalar_label")


def load_annotated_mesh(path: str, label_property: str = ""):
    """PLY → (verts [V,3] f32, faces [F,3] i32, face_labels [F] i32).
    Per-vertex labels are reduced to per-face by majority-of-3."""
    c = read_ply(path)
    if c.faces is None:
        raise SystemExit(f"{path}: no triangle faces")
    verts = c.xyz().astype(np.float32)
    names = list(c.vertex.dtype.names)
    prop = label_property or next((p for p in LABEL_PROPS if p in names), "")
    if not prop:
        raise SystemExit(f"{path}: no label property among {LABEL_PROPS}; "
                         f"found {names} (pass --label_property)")
    vlab = np.asarray(c.vertex[prop]).astype(np.int32)
    vl = vlab[c.faces]                                      # [F, 3]
    face_labels = np.where(vl[:, 1] == vl[:, 2], vl[:, 1], vl[:, 0])
    return verts, c.faces.astype(np.int32), face_labels.astype(np.int32)


def main(argv=None):
    p = ArgumentParser(description="Render GT label maps from annotated mesh")
    p.add_argument("--mesh", required=True)
    p.add_argument("--camera_params", required=True,
                   help="stage camera JSON (same format the lift consumes)")
    p.add_argument("--image_size", type=int, nargs=2, required=True,
                   metavar=("W", "H"))
    p.add_argument("--downsample", type=float, default=0.5,
                   help="intrinsics/extent scale (the lift runs at 0.5×)")
    p.add_argument("--out_dir", default="output/gt_labels")
    p.add_argument("--label_property", default="")
    p.add_argument("--max_views", type=int, default=0)
    p.add_argument("--face_chunk", type=int, default=262_144)
    p.add_argument("--max_tiles_per_axis", type=int, default=8)
    p.add_argument("--max_per_tile", type=int, default=256)
    p.add_argument("--save_png", action="store_true",
                   help="also write palette-colored PNGs for inspection")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to rasterize; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    device = require_device(args.device)

    verts, faces, face_labels = load_annotated_mesh(args.mesh,
                                                    args.label_property)
    print(f"[INFO] mesh: {len(verts)} verts, {len(faces)} faces, "
          f"{len(np.unique(face_labels))} labels")
    verts_d = torch.as_tensor(verts, device=device)
    faces_d = torch.as_tensor(faces, device=device)
    labels_d = torch.as_tensor(face_labels, device=device)

    name_to_entry, cam_params, _ = load_camera_json(args.camera_params)
    W = int(round(args.image_size[0] * args.downsample))
    H = int(round(args.image_size[1] * args.downsample))
    os.makedirs(args.out_dir, exist_ok=True)

    names = sorted(name_to_entry)
    if args.max_views:
        names = names[:args.max_views]
    for name in names:
        entry = name_to_entry[name]
        R = np.asarray(entry["R"], np.float32)              # world→cam
        t = np.asarray(entry["tvec"], np.float32)
        viewmat = np.eye(4, dtype=np.float32)
        viewmat[:3, :3] = R
        viewmat[:3, 3] = t
        key = str(entry.get("camera_id"))
        intr = (np.asarray(cam_params[key], np.float32) if key in cam_params
                else np.asarray(entry["intrinsic"][:4], np.float32))
        fx, fy, cx, cy = intr * args.downsample
        label, _depth, overflow = rasterize_mesh_labels_chunked(
            verts_d, faces_d, labels_d, torch.as_tensor(viewmat, device=device),
            float(fx), float(fy), float(cx), float(cy), W, H, face_chunk=args.face_chunk,
            max_tiles_per_axis=args.max_tiles_per_axis,
            max_per_tile=args.max_per_tile)
        if int(overflow) > 0:
            print(f"[WARN] {name}: {int(overflow)} faces beyond per-tile "
                  f"K={args.max_per_tile} — GT labels may be wrong in dense "
                  f"tiles; raise --max_per_tile")
        label = label.cpu().numpy()
        save_label_map(os.path.join(args.out_dir, f"{name}_labels.pt"), label)
        if args.save_png:
            from PIL import Image

            pal = bit_shuffle_palette(256)
            Image.fromarray(pal[np.clip(label, 0, 255)]).save(
                os.path.join(args.out_dir, f"{name}_labels.png"))
        cov = float((label != MISS_LABEL).mean())
        print(f"  {name}: coverage {cov*100:.1f}%")
    print(f"[DONE] GT label maps → {args.out_dir}")


if __name__ == "__main__":
    main()
