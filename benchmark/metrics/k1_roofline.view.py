"""K1's share of its roofline on the traced frames, in %: the bound
(``roofline.k1_bound`` on the rows K1 reads and the pair-pixels that pass the
cut, counted by the reference from these frames' inputs) over K1's device
time from the profiler's trace."""

from benchmark.harness import roofline
from benchmark.harness.trace import device_seconds

K1 = "blend_fwd_kernel"


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    t = device_seconds(tr or {}, match=K1)
    if not work or t <= 0:
        return None
    bound_ms = sum(roofline.k1_bound(w["rows_fwd"], w["hits_fwd"], w["channels"],
                                     w["tiles"])[0] for w in work)
    return 100.0 * bound_ms * 1e-3 / t
