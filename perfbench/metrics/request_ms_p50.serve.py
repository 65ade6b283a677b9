"""Median request latency of the measured (untraced) window, in ms."""
from perfbench.readers import latency_p50_ms


def read(ctx):
    return latency_p50_ms(ctx)
