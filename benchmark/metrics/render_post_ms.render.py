"""The host's time a view in the post-processing, ms: the self times of the
program's spans ``render_cli.labels`` (the NumPy argmax) and
``render_cli.confidence`` (the float64 top1 − top2 confidence and the fp16
cast), a traced view. None where the program has neither."""

from benchmark.harness.spans import self_ms

SPANS = ("render_cli.labels", "render_cli.confidence")


def read(ctx):
    got = [self_ms(ctx, name) for name in SPANS]
    if all(v is None for v in got):
        return None
    return sum(v or 0.0 for v in got)
