"""Device ms a unit of the kernels launched from models/feature_gaussians.py:
the K-neighbour smoothing (forward; its backward is autograd's)."""
from perfbench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "smoothing")
