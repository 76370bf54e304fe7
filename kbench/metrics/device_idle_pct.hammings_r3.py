"""Share of the restricted hammings cell's (-r 3) window in which the
device ran nothing."""
from kbench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
