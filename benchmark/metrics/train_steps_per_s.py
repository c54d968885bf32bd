"""Train steps per second: every step of the window over the window's whole
time (host clock, from the first call until the device has finished the
last step)."""


def read(ctx):
    w = ctx["window"]
    return w["count"] / w["window_s"]
