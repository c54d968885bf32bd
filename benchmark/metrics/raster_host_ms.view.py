"""The host's time in the render call, ms a frame: the benchmark's own span
around ``render_semantics`` (the enqueue: the path does not wait inside),
the mean over the window's frames."""


def read(ctx):
    spans = ctx["window"]["spans"]
    return sum(s["call"] for s in spans) / len(spans) * 1e3
