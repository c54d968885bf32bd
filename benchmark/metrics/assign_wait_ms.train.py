"""The step's one wait for the device, ms a traced step: the program's span
``train.assign.fetch`` (the cost and the present mask copied to the host,
which waits for every kernel queued before them)."""

from benchmark.harness.spans import self_ms


def read(ctx):
    return self_ms(ctx, "train.assign.fetch")
