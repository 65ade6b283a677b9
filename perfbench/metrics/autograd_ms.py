"""Device ms a step of the kernels launched by the autograd engine, other
than the backward blend kernel."""
from perfbench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "autograd")
