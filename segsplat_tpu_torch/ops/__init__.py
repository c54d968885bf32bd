"""Ops: EWA projection, tile binning, the tile blend (kernels K1 and K2), kNN,
the linear sum assignment, voxel quantization and the feature lifts (DDA and
splat first hit)."""
