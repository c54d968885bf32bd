"""The projection's host time, ms a traced frame: the program's span
``raster.project`` (EWA projection and the offset's add, enqueued)."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "raster.project")
