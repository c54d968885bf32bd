"""The host assignment's time, ms a traced step: the program's span
``train.assign.solve`` (the LAP on the fetched [256, 256] cost, numpy)."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "train.assign.solve")
