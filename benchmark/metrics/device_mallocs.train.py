"""The CUDA caching allocator's device allocations (``num_device_alloc``),
a traced step: the count ``device_mallocs`` of the program's span
``train.step``; None off the card."""

from benchmark.harness.spans import count


def read(ctx):
    return count(ctx, "train.step", "device_mallocs")
