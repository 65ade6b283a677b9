"""Device ms a unit of the backward segment ``bwd.preprocess``, from the
per-Gaussian tensors (edge b) to the end of the scene step's backward:
projection, SH and the activations."""
from perfbench.program_spans import segment_ms


def read(ctx):
    return segment_ms(ctx, "preprocess")
