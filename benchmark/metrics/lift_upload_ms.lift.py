"""The host's time a view in the map's copy to the card, ms: the program's
span ``lift.upload`` (from pageable memory, so it holds the wait for the
work queued before it), a traced view."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "lift.upload")
