"""What the program's own spans and counters say of the traced window.

The port records them itself (``seganygaussians_torch/utils/tracing.py``)
while a torch profiler runs, so the window of ``trace.profile`` is theirs
too; this module reads its ``summary()`` and divides by the window's units.
Every reader returns None where the window holds nothing for it: a program
without the tracing module, a span or counter it never recorded, or device
time on the CPU.
"""

from __future__ import annotations

from typing import Optional


def summary() -> Optional[dict]:
    """The program's record of the last profiled window, or None."""
    try:
        from seganygaussians_torch.utils import tracing
    except ImportError:
        return None
    return tracing.summary()


def segment_ms(ctx, segment: str) -> Optional[float]:
    """Device ms a unit of the backward segment ``bwd.<segment>``."""
    s = summary()
    seg = (s or {}).get("segments", {}).get("bwd." + segment)
    if seg is None or seg["device_ms"] is None or not ctx.trace.units:
        return None
    return seg["device_ms"] / ctx.trace.units


def counter_per_unit(ctx, name: str) -> Optional[float]:
    s = summary()
    n = (s or {}).get("counters", {}).get(name)
    if n is None or not ctx.trace.units:
        return None
    return n / ctx.trace.units


def capacity_use_pct(ctx) -> Optional[float]:
    """Instances binned over the slots the instance budget made, in percent."""
    counters = (summary() or {}).get("counters", {})
    cap = counters.get("raster.capacity")
    if not cap:
        return None
    return 100.0 * counters.get("raster.instances", 0) / cap
