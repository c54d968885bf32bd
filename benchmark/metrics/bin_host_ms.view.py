"""The binning's host time, ms a traced frame: the program's span
``raster.bin`` (depth sort, tile keys, key sort, searchsorted, the pair
counts and the cap)."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "raster.bin")
