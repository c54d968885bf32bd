"""Utilities: config/flag system, palettes, profiling, system and device helpers."""

from segsplat_tpu_torch.utils.config import (ModelParams, OptimizationParams, ParamGroup,
                                             PipelineParams, get_combined_args, save_cfg_args)
from segsplat_tpu_torch.utils.palette import bit_shuffle_palette
from segsplat_tpu_torch.utils.profiling import StepTimer, annotate, timed, trace
from segsplat_tpu_torch.utils.system import (mkdir_p, require_device, safe_state,
                                             search_for_max_iteration)

__all__ = [
    "ModelParams", "OptimizationParams", "ParamGroup", "PipelineParams",
    "get_combined_args", "save_cfg_args", "bit_shuffle_palette",
    "StepTimer", "annotate", "timed", "trace",
    "mkdir_p", "require_device", "safe_state", "search_for_max_iteration",
]
