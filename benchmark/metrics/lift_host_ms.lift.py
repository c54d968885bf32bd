"""The host's time a view in the lift but the upload, ms: the self times of
the program's spans ``lift.resize``, ``lift.projection``, ``lift.binning``,
``lift.tile_test``, ``lift.accumulation`` and ``lift.view`` (the view's
span, less the stages and the upload inside it), a traced view. None
where the program has no ``lift.view``."""

from benchmark.harness.spans import self_ms

STAGES = ("lift.resize", "lift.projection", "lift.binning", "lift.tile_test",
          "lift.accumulation")


def read(ctx):
    view = self_ms(ctx, "lift.view")
    if view is None:
        return None
    return view + sum(self_ms(ctx, name) or 0.0 for name in STAGES)
