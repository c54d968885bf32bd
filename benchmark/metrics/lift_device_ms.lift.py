"""The device's time a view, every kernel, copy and set, from the
profiler's trace, in ms."""

from benchmark.harness.trace import device_seconds


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("iterations") or not tr.get("device_total_s"):
        return None
    return device_seconds(tr) / tr["iterations"] * 1e3
