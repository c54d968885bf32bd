"""The payload gather's host time, ms a traced frame: the program's span
``raster.gather`` (the payload rows, their gather into per-tile runs, the
pad)."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "raster.gather")
