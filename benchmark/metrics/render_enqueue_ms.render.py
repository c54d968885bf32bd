"""The host's time a view in the enqueue and the glue, ms: the self times of
the program's spans ``render_cli.view`` (the view's span, less the batch,
the fetch and the post-processing inside it), ``render_cli.batch`` (a
batch's enqueue and its one counter sync) and the render and rasterizer
spans inside them, a traced view. None where the program has no
``render_cli.view``."""

from benchmark.harness.spans import self_ms

INSIDE = ("render_cli.batch", "render.semantics", "render.render", "raster.project",
          "raster.bin", "raster.gather", "raster.blend")


def read(ctx):
    view = self_ms(ctx, "render_cli.view")
    if view is None:
        return None
    return view + sum(self_ms(ctx, name) or 0.0 for name in INSIDE)
