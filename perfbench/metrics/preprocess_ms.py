"""Device ms a unit of the kernels launched from the projection, SH and
activations (ops/projection.py, ops/sh.py, ops/transforms.py,
models/gaussians.py), forward only: their backward is autograd's."""
from perfbench.readers import layer_ms


def read(ctx):
    return layer_ms(ctx, "preprocess")
