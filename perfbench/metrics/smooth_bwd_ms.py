"""Device ms a unit of the backward segment ``bwd.smoothing``, from the
per-Gaussian colors (edge b) to the end of the feature step's backward: the
normalise and the K-neighbour smoothing."""
from perfbench.program_spans import segment_ms


def read(ctx):
    return segment_ms(ctx, "smoothing")
