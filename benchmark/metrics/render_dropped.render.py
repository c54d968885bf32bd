"""The pairs a view drops past the pair cap, from the program's count
``dropped`` of the span ``render_cli.view``, a traced view: 0 on the default
path, which takes no cap. None where the program keeps no such count."""

from benchmark.harness.spans import count


def read(ctx):
    return count(ctx, "render_cli.view", "dropped")
