"""Several devices on ``torch.distributed``, one process a device: a
(view, tensor) mesh, the view-split feature lift, the strip render and the
B-view train step (the counterpart of segsplat_tpu/parallel/)."""

from segsplat_tpu_torch.parallel.mesh import (TENSOR_AXIS, VIEW_AXIS, channel_shard,
                                              make_mesh, replicate, view_shard)
from segsplat_tpu_torch.parallel.lift import lift_views_sharded
from segsplat_tpu_torch.parallel.render import rasterize_sharded
from segsplat_tpu_torch.parallel.train import make_parallel_train_step

__all__ = [
    "TENSOR_AXIS", "VIEW_AXIS", "channel_shard", "make_mesh", "replicate", "view_shard",
    "lift_views_sharded", "make_parallel_train_step", "rasterize_sharded",
]
