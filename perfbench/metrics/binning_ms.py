"""Device ms a unit of the kernels launched from ops/binning.py: the depth
sort, the slot expansion and the (tile, depth) sort."""
from perfbench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "binning")
