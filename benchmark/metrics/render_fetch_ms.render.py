"""The host's time a view in the fetch, ms: the program's span
``render_cli.fetch`` (the wait for the view and the copy of its [P, H, W]
logits to pageable host memory), a traced view. None where the program has
no such span."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "render_cli.fetch")
