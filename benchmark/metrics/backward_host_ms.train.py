"""The autograd backward's host time, ms a traced step: the program's span
``train.backward`` around ``total.backward()``."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "train.backward")
