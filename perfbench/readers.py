"""What the per-layer metric files (``perfbench/metrics/*.py``) read.

A reader returns None where the traced window holds nothing for it, and the
harness then leaves the metric out of the line; a share of a roofline or of
a peak is never reported as 0 for want of a reading.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple, Optional

from perfbench.trace import Trace
from perfbench.work import blend


class Context(NamedTuple):
    trace: Trace
    unit_s: float  # measured seconds per step or request, untraced window
    work: dict  # "blend_fwd", "blend_bwd", "step" -> (bytes, operations) per unit
    latencies_ms: list  # per request, untraced window (serving cells)
    late_ms: list = []  # how late each request was issued after its due time (serving cells)


def layer_ms(ctx: Context, *layers: str) -> Optional[float]:
    """Device milliseconds a unit of the kernels of ``layers``."""
    s = sum(ctx.trace.layer_s.get(layer, 0.0) for layer in layers)
    return s / ctx.trace.units * 1e3 if s > 0 and ctx.trace.units else None


def roofline_pct(ctx: Context, layer: str, work_key: str) -> Optional[float]:
    """The kernel's least time for the modelled work over its measured
    device time, in percent."""
    t = ctx.trace.layer_s.get(layer, 0.0)
    w = ctx.work.get(work_key)
    if t <= 0 or w is None or not ctx.trace.units:
        return None
    return blend.least_seconds(*w) * ctx.trace.units / t * 100.0


def step_mfu_pct(ctx: Context) -> Optional[float]:
    """The whole unit's least time, by bytes or operations, over its
    measured time (untraced), in percent."""
    w = ctx.work.get("step")
    if w is None or not ctx.unit_s:
        return None
    return blend.least_seconds(*w) / ctx.unit_s * 100.0


def idle_pct(ctx: Context) -> Optional[float]:
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def latency_p50_ms(ctx: Context) -> Optional[float]:
    return statistics.median(ctx.latencies_ms) if ctx.latencies_ms else None


def generator_late_ms(ctx: Context) -> Optional[float]:
    """Mean milliseconds by which the open loop issued a request after it
    was due: the wait behind a slower request, plus the generator's own
    delay."""
    return statistics.fmean(ctx.late_ms) if ctx.late_ms else None
