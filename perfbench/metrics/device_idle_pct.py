"""Share of the traced window in which no device operation runs."""
from perfbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
