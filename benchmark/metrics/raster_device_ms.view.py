"""The device's time a frame in everything but K1 (projection, sorts,
gathers, argmax, the label copy), from the profiler's trace, in ms."""

from benchmark.harness.trace import device_seconds

K1 = "blend_fwd_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("iterations") or not tr.get("device_total_s"):
        return None
    return device_seconds(tr, exclude=K1) / tr["iterations"] * 1e3
