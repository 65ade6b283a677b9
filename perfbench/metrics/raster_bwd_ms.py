"""Device ms a unit of the backward segment ``bwd.raster``, from the
rasterizer's image (edge a) to the per-Gaussian tensors that enter the
depth-order gathers (edge b): ``tiles_to_image``, the backward blend kernel,
the table and the gathers."""
from perfbench.program_spans import segment_ms


def read(ctx):
    return segment_ms(ctx, "raster")
