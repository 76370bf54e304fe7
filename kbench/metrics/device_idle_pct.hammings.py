"""Share of the exhaustive hammings cell's window in which the device
ran nothing."""
from kbench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
