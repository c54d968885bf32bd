"""The whole view's share of the chip's roofline, in %: the least time a
view needs, max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) with the bytes
and operations of ``reference/lift.view_bytes`` and ``view_ops`` (the fp16
map read once, the hit voxels' rows and counts read and written once, one
add a hit ray and channel) counted on the traced views from the reference's
march, whatever implements them, over the window's mean view period."""

from benchmark.harness import roofline


def read(ctx):
    work, w = ctx["work"], ctx["window"]
    if not work:
        return None
    least = sum(max(x["bytes"] / roofline.PEAK_HBM_BYTES, x["ops"] / roofline.PEAK_FP32_FLOPS)
                for x in work) / len(work)
    return 100.0 * least / (w["window_s"] / w["count"])
