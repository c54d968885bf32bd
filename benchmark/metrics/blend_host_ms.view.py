"""The blend's host time, ms a traced frame: the program's span
``raster.blend``, the dispatch of K1's registered op and its launch."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "raster.blend")
