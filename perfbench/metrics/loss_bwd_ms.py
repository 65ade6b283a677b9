"""Device ms a unit of the backward segment ``bwd.loss``, from the start of
the backward to the gradient's arrival at the rasterizer's image (the
program's edge a): L1 + SSIM in a scene step; the correlations, the gate and
the feature-norm term in a feature step."""
from perfbench.program_spans import segment_ms


def read(ctx):
    return segment_ms(ctx, "loss")
