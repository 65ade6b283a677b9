"""The whole step's (or request's) share of the card's peak: its modelled
least time (work/step.py) over its measured time."""
from perfbench.readers import step_mfu_pct


def read(ctx):
    return step_mfu_pct(ctx)
