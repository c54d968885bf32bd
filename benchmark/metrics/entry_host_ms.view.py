"""The render entry's host time, ms a traced frame: the self time of the
program's span ``render.semantics`` (the activated table, the payload, the
permute; the rasterizer's stages are its children)."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "render.semantics")
