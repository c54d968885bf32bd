"""The share of the window in which the card runs no kernel, copy or set, in
%: the traced device busy time a view over the untraced window's mean view
(``harness/trace.idle_pct``)."""

from benchmark.harness.trace import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"], ctx["window"])
