"""Utilities: config/flag system, palettes, profiling, system and device helpers."""

from segsplat_tpu_torch.utils.config import (ModelParams, OptimizationParams, ParamGroup,
                                             PipelineParams, get_combined_args,
                                             load_json_config, save_cfg_args)
from segsplat_tpu_torch.utils.palette import bit_shuffle_palette, colorize_labels
from segsplat_tpu_torch.utils.profiling import annotate, trace
from segsplat_tpu_torch.utils.system import (mkdir_p, require_device, safe_state,
                                             search_for_max_iteration)

__all__ = [
    "ModelParams", "OptimizationParams", "ParamGroup", "PipelineParams",
    "get_combined_args", "load_json_config", "save_cfg_args",
    "bit_shuffle_palette", "colorize_labels",
    "annotate", "trace",
    "mkdir_p", "require_device", "safe_state", "search_for_max_iteration",
]
