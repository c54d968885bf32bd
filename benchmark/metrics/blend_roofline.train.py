"""The blend kernels' share of their roofline in the traced steps, in %:
K1's bound plus K2's (``roofline.k1_bound``, ``k2_bound`` on the rows each
reads and the pair-pixels that pass the cut, counted by the reference from the
geometry each step read) over K1's and K2's device time from the trace."""

from benchmark.harness import roofline
from benchmark.harness.trace import device_seconds


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    t = device_seconds(tr or {}, match="blend_fwd_kernel") + device_seconds(
        tr or {}, match="blend_bwd_kernel")
    if not work or t <= 0:
        return None
    ms = sum(roofline.k1_bound(w["rows_fwd"], w["hits_fwd"], w["channels"], w["tiles"])[0]
             + roofline.k2_bound(w["payload_rows"], w["rows_bwd"], w["hits_bwd"], w["channels"],
                                 w["tiles"])[0] for w in work)
    return 100.0 * ms * 1e-3 / t
