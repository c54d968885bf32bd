"""The slots a view truncates, from the program's count ``overflow`` of the
span ``lift.binning`` (big cubes past the dual binning's budget and tile
candidates past K), a traced view: 0 when the lift dropped no coverage.
None where the program keeps no such count."""

from benchmark.harness.spans import count


def read(ctx):
    return count(ctx, "lift.binning", "overflow")
