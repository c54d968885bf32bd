"""File I/O: PLY, COLMAP, scene readers, stage artifacts and provenance."""

from segsplat_tpu_torch.io.ply import (PlyContent, load_gaussian_ply, read_ply,
                                       read_voxel_grid_ply, save_gaussian_ply, write_ply,
                                       write_voxel_grid_ply)

__all__ = ["PlyContent", "read_ply", "write_ply", "read_voxel_grid_ply",
           "write_voxel_grid_ply", "save_gaussian_ply", "load_gaussian_ply"]
