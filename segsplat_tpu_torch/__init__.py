"""segsplat_tpu_torch — the PyTorch/CUDA port of segsplat_tpu for NVIDIA Hopper.

The JAX package ``segsplat_tpu`` stays the reference; this package mirrors its
layout (core/, eval/, io/, ops/, pipeline/, train/, utils/, scene.py, render.py)
so each counterpart sits at the same path. It imports torch and never jax, nor
anything of ``segsplat_tpu``.

Ported so far: semantic novel-view rendering of a trained scene (the CLI twin
``segsplat_tpu_torch/render_semantics_logits.py``), Unified-Lift training
(``python -m segsplat_tpu_torch.train``, the twin of the root train.py), and
feature lifting: the voxel grid (``minkowski_voxel_grid_from_ply_advanced.py``)
and the multi-view lift (``aggregate_voxel_features_onthefly.py``), and the
open-vocabulary query (``voxeltoGaussian_logits.py``), the one-command pipeline
(``run_pipeline.py``), the LSeg feature extraction
(``extract_lseg_features.py``) and the CLIP text tower and LSeg in torch.nn
(``models/``); pseudo-labels (``prepare_pseudo_label.py``,
``pseudo_label_loop.py``) with the LERF-Masked and ScanNet++ evaluation and the
offline hard-scene tools; object editing (``edit_object_removal.py``,
``edit_object_inpaint.py``: removal, the inpainting set-up and the masked
finetune), the two 2D inpainters (``ops/inpaint.py``, ``ops/inpaint_patch.py``,
``inpaint_images.py``) and LPIPS (``eval/lpips.py``, ``eval_inpaint_lpips.py``).
The tile blend is hand-written CUDA kernels, forward and backward
(``csrc/blend_fwd.cu``, ``csrc/blend_bwd.cu``, bound in ``ops/blend.py``), and
the packed forward (``csrc/blend_packed.cu``).

Entry points run on the card (``device="cuda"``) unless the caller asks for the
CPU; they raise when CUDA is missing instead of falling back.
"""

import torch

# Full fp32 everywhere: the projection's means3d @ R.T must not drop to TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The CPU build's vector math library initialises itself on its first call. When
# that first call is a large exp split over several threads, one thread's share
# can come back at about 1e-4 relative error (seen with torch 2.13 CPU builds,
# in a few processes of every ten), which moves the plain blend past its 1e-4
# tolerance. One small call, made here on one thread, does the set-up first.
torch.exp(torch.zeros(1))

__version__ = "0.1.0"
