"""Mean ms by which the open loop issued a request after it was due, in the
measured (untraced) window."""
from perfbench.readers import generator_late_ms


def read(ctx):
    return generator_late_ms(ctx)
