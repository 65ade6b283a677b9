"""Share of the instance budget's slots that hold instances, summed over the
window's frames: 100 × Σ ``raster.instances`` ÷ Σ ``raster.capacity`` (the
program's binning counters)."""
from perfbench.program_spans import capacity_use_pct


def read(ctx):
    return capacity_use_pct(ctx)
