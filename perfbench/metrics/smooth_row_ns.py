"""Device ns of the smoothing forward (the kernels launched from
models/feature_gaussians.py, as ``smooth_ms`` reads them) per neighbour row
it gathers (the program's ``smoothing.rows`` counter: N·K_i summed over the
multi-resolution levels).  None where the program counts no rows."""
from perfbench.program_spans import counter_per_unit
from perfbench.readers import layer_ms


def read(ctx):
    ms, rows = layer_ms(ctx, "smoothing"), counter_per_unit(ctx, "smoothing.rows")
    if ms is None or not rows:
        return None
    return ms * 1e6 / rows
