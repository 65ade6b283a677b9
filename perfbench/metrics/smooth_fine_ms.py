"""Device ms a unit of the multi-resolution level that gathers the most
rows: the program's span ``saga:smoothing.level<i>`` whose counter
``smoothing.rows.level<i>`` is the largest (SAGA's K = 16 level over every
point).  None where the program has no level spans or no device time."""
from perfbench.program_spans import summary

COUNTER = "smoothing.rows.level"


def read(ctx):
    s = summary() or {}
    rows = {name[len(COUNTER):]: n for name, n in s.get("counters", {}).items()
            if name.startswith(COUNTER)}
    if not rows or not ctx.trace.units:
        return None
    span = s.get("spans", {}).get("smoothing.level" + max(rows, key=rows.get))
    if span is None or span["device_ms"] is None:
        return None
    return span["device_ms"] / ctx.trace.units
