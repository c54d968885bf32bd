"""The share of the payload rows the gather copies that K1 never reads, in %,
over the traced frames: 100 · (rows − (pairs − pairs_past_k)) / rows, from
the program's span counts ``raster.gather``'s ``rows`` (the rows gathered,
one a (tile, Gaussian) slot of the sort, before the K pad) and
``raster.bin``'s ``pairs`` (the real pairs) and ``pairs_past_k`` (those past
the per-tile cap K). None where the program keeps no such counts."""

from benchmark.harness.spans import count


def read(ctx):
    rows = count(ctx, "raster.gather", "rows")
    pairs = count(ctx, "raster.bin", "pairs")
    past = count(ctx, "raster.bin", "pairs_past_k")
    if rows is None or pairs is None or past is None or rows <= 0:
        return None
    return 100.0 * (rows - (pairs - past)) / rows
