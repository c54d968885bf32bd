"""The views whose map took the staged upload, a traced view: the program's
count ``staged`` of the span ``lift.upload`` (the host's copy into pinned
memory and the transfer on a copy stream), 1 where every view took it. None
where the program keeps no such count."""

from benchmark.harness.spans import count


def read(ctx):
    return count(ctx, "lift.upload", "staged")
