"""Core types (GaussianTable, Camera, VoxelGrid) and the camera helpers."""

from segsplat_tpu_torch.core.types import Camera, GaussianTable, VoxelGrid

__all__ = ["Camera", "GaussianTable", "VoxelGrid"]
