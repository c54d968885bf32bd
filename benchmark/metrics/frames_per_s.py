"""Views delivered to the host per second: every frame of the window over the
window's whole time (host clock, from the first call to the last labels)."""


def read(ctx):
    w = ctx["window"]
    return w["count"] / w["window_s"]
