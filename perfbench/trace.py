"""A profiled window: device time by layer and by kernel, busy time, and the
breakdown of the longest device operations and idle gaps.

The spans are the benchmark's own: for the traced window every function of
the program's modules named in ``perfbench/layers.json`` is wrapped in a
``record_function`` span named ``layer:<layer>`` (and unwrapped after it).
``torch.profiler`` records the spans, the CPU ops and the CUDA runtime
calls under them, and the device's kernels and copies.  A device operation
belongs to the runtime call that launched it (the same correlation id), and
so to its ops and spans: a blend kernel goes by its name; an op run by the
autograd engine goes to ``autograd``; anything else to the innermost
``layer:`` span above it, or ``outside`` (the benchmark's own code).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import inspect
import json
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

SPAN = "layer:"


class Trace(NamedTuple):
    units: int  # steps or requests in the window
    window_s: float  # host seconds from the window's start to its end
    busy_s: float  # seconds in which some device operation ran
    layer_s: dict  # layer -> device seconds
    kernel_s: dict  # device operation name -> seconds
    breakdown: dict  # {"device_ops": [[name, s]...], "idle_gaps": [[what, s]...]}


def _spanned(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def layer_spans(table: dict):
    """Wrap the layer modules' functions, wherever the program refers to them."""
    layers = table["modules"]
    patched = []
    for mod_name, module in list(sys.modules.items()):
        if not mod_name.startswith(("seganygaussians_torch", "perfbench.cells")) or module is None:
            continue
        for attr, value in list(vars(module).items()):
            if inspect.isfunction(value) and value.__module__ in layers:
                patched.append((module, attr, value))
                setattr(module, attr, _spanned(value, SPAN + layers[value.__module__]))
    try:
        yield
    finally:
        for module, attr, value in patched:
            setattr(module, attr, value)


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _layer_of(event, table: dict, memo: dict) -> str:
    """The layer of a CPU event: autograd if the engine runs it, else the
    innermost span above it."""
    chain, e, layer = [], event, None
    while e is not None:
        hit = memo.get(id(e))
        if hit is not None:
            layer = hit
            break
        chain.append(e)
        if e.name.startswith("autograd::engine::evaluate_function"):
            layer = table["autograd"]
            break
        if e.name.startswith(SPAN):
            layer = e.name[len(SPAN):]
            break
        e = e.cpu_parent
    layer = layer or table["outside"]
    for c in chain:
        memo[id(c)] = layer
    return layer


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(run: Callable[[int], None], units: int, table_path: Path) -> Trace:
    """Profile ``run(units)``.  Without a card (the CPU tests) only the host
    is traced, and no device time is found."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    table = json.loads(Path(table_path).read_text())
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with layer_spans(table), torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run(units)
        if card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = list(prof.events())
    cpu = [e for e in events if not _is_device(e)]
    # The device timeline also mirrors each span as an annotation: only
    # kernels, copies and sets are device work.
    spans_named = {e.name for e in cpu}
    device = [e for e in events if _is_device(e) and e.name not in spans_named]
    # A kernel or copy and the runtime call that launched it share an id.
    launches = {e.id: e for e in cpu if e.name.startswith(("cuda", "cu"))}
    memo: dict[int, str] = {}
    layer_s: dict[str, float] = {}
    kernel_s: dict[str, float] = {}
    spans = []
    for d in device:
        s, e = d.time_range.start, d.time_range.end
        dur = (e - s) * 1e-6
        layer = next((v for k, v in table["kernels"].items() if k in d.name), None)
        if layer is None:
            launch = launches.get(d.id)
            layer = _layer_of(launch, table, memo) if launch is not None else table["outside"]
        layer_s[layer] = layer_s.get(layer, 0.0) + dur
        kernel_s[d.name] = kernel_s.get(d.name, 0.0) + dur
        spans.append((s, e))
    busy = _merged(spans)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    threads = [e.thread for e in cpu]
    main = max(set(threads), key=threads.count) if threads else 0
    print(f"perfbench: traced {units} units in {window_s:.3f} s, device by layer "
          + json.dumps({k: round(v, 6) for k, v in sorted(layer_s.items())}),
          file=sys.stderr, flush=True)
    return Trace(units, window_s, busy_s, layer_s, kernel_s,
                 _breakdown(kernel_s, busy, cpu, main))


def _breakdown(kernel_s: dict, busy, cpu, main) -> dict:
    """The ten longest device operations by total time, and the ten longest
    idle gaps between device work, each named by the innermost host event
    running at its middle on the main thread."""
    device_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:10]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in cpu if e.thread == main)
    starts = [h[0] for h in host]
    idle = []
    for length, mid in gaps:
        name = "no host event"
        i = bisect.bisect_right(starts, mid)
        for s, e, n in reversed(host[max(0, i - 2000):i]):
            if e >= mid:
                name = n
                break
        idle.append([name, length * 1e-6])
    return {"device_ops": [[n, s] for n, s in device_ops], "idle_gaps": idle}
