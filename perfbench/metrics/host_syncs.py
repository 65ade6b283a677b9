"""Explicit device-to-host reads a unit (the program's ``host_syncs``
counter, one at each ``saga:sync.<site>`` span)."""
from perfbench.program_spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "host_syncs")
