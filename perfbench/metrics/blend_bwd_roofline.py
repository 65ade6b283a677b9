"""The backward blend kernel's least time for the work these inputs need
(work/blend.py) over its device time, in percent."""
from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "blend_bwd", "blend_bwd")
