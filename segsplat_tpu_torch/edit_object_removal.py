"""Object removal on a trained scene, the port's twin of
scripts/edit_object_removal.py (the same flags, plus ``--device``):

    python -m segsplat_tpu_torch.edit_object_removal -m MODEL --select_obj_id 3 7
        [--iteration N] [--classifier classifier.npz] [--device cuda|cpu]

The reference's edit_object_removal workflow (script/debug_checks_scripts/
edit_object_removal.sh; the .py it calls is absent upstream, so this follows
its documented behaviour): classify the Gaussians with the trained codebook,
deactivate the selected object ids and save the edited point cloud as
iteration ``--out_iteration`` (default: the loaded one + 1).
"""

from __future__ import annotations

from argparse import ArgumentParser

from segsplat_tpu_torch.io.artifacts import find_codebook, load_codebook
from segsplat_tpu_torch.scene import Scene
from segsplat_tpu_torch.train.editing import mask3d_from_classes, removal_setup
from segsplat_tpu_torch.utils.config import ModelParams, get_combined_args
from segsplat_tpu_torch.utils.system import require_device


def main(argv=None) -> str:
    parser = ArgumentParser()
    ModelParams(parser, sentinel=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--select_obj_id", type=int, nargs="+", required=True)
    parser.add_argument("--classifier", default="")
    parser.add_argument("--out_iteration", type=int, default=0,
                        help="iteration tag for the edited save (default: "
                             "loaded_iter + 1)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to classify; cuda raises when no GPU is present")
    args = get_combined_args(parser, argv)
    device = require_device(args.device)

    scene = Scene(args.source_path, args.model_path, images=args.images,
                  shuffle=False, load_iteration=args.iteration, device=device)
    code_book = load_codebook(args.classifier or find_codebook(args.model_path,
                                                               scene.loaded_iter))
    mask = mask3d_from_classes(scene.gaussians, code_book, args.select_obj_id)
    print(f"[INFO] removing {int(mask.sum())} gaussians (ids {args.select_obj_id})")
    edited = removal_setup(scene.gaussians, mask)
    path = scene.save(args.out_iteration or (scene.loaded_iter + 1), edited)
    print(f"[DONE] → {path}")
    return path


if __name__ == "__main__":
    main()
