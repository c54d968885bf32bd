"""Ops: EWA projection, tile binning, the tile blend (kernels K1 and K2), kNN
and the linear sum assignment."""
