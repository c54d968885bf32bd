"""The 95th percentile of every window frame's time, from the call until its
labels are on the host (host clock), in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile([s["frame"] for s in ctx["window"]["spans"]], 95)) * 1e3
