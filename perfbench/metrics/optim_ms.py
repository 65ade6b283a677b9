"""Device ms a step of the kernels launched from models/optim.py (Adam)."""
from perfbench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "optim")
