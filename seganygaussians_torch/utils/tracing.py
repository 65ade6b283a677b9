"""The port's spans and counters: on exactly while a torch profiler records.

Tracing is on while ``torch.autograd.profiler._is_profiler_enabled`` is true,
that is inside any ``torch.profiler.profile``; there is no other switch.  Off,
a span, mark or counter costs that one read: no ``record_function``, no CUDA
event, no autograd node.

On:

* :func:`span` enters ``record_function("saga:<name>")`` (the unit's or the
  request's id as its args), so the span sits in the profiler's timeline on
  the kernels' clock, and keeps its host start and end, its parent and, once
  CUDA is up, a CUDA event at each end on the current stream.
* :func:`sync` is a span ``saga:sync.<site>`` round a call that waits for
  the device, counted as ``host_syncs``.
* :func:`mark` puts an identity autograd node on tensors; its backward fires
  once all their gradients are in, records a CUDA event and an instant span
  ``saga:bwd.<edge>``, and so cuts the backward that :func:`backward` brackets
  into named segments timed on the device.
* :func:`count` adds to a counter.

The store holds the last profiled window: it is cleared when a profiler
session starts, and read with :func:`summary`.  :class:`ProfileWindow`
profiles a fixed run of a training loop's iterations and writes a Chrome
trace and ``spans.json``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import torch
import torch.autograd.profiler as _profiler

PREFIX = "saga:"


class _Off:
    """The context manager of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


_streams: dict = {}  # (stream id, device, type) -> torch.cuda.Stream


def _event():
    """A CUDA event recorded now on the current stream, or None before CUDA
    is up (CPU tensors).  The stream object is looked up by the current
    stream's key: making one anew (``torch.cuda.current_stream()``) costs more
    host time than the record."""
    if not torch.cuda.is_initialized():
        return None
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


_KERNEL_MODULES = (("seganygaussians_torch.ops.blend_cuda", "blend"),
                   ("seganygaussians_torch.ops.preprocess_cuda", "preprocess"),
                   ("seganygaussians_torch.ops.smooth_cuda", "smooth"))


def _kernels() -> dict:
    """The hand-written kernels' launch counters (``blend_fwd``,
    ``blend_bwd``, ``preprocess_fwd``, ``preprocess_bwd``, ``smooth_fwd``,
    ``smooth_bwd``), of each kernels module that is loaded."""
    out = {}
    for name, prefix in _KERNEL_MODULES:
        mod = sys.modules.get(name)
        if mod is not None and hasattr(mod, "BACKWARD"):
            out.update({f"{prefix}_fwd": mod.FORWARD, f"{prefix}_bwd": mod.BACKWARD})
    return out


class _Store:
    """What the window recorded."""

    def __init__(self):
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.spans: list[_Span] = []
        self.counters: dict[str, int] = {}
        self.edges: list[tuple] = []  # (segment ending here, event, host ns)
        self.segments: list[tuple] = []  # (name, event0, event1, ns0, ns1)
        self.requests = 0
        self.launches0 = {k: v.launches for k, v in _kernels().items()}

    def stack(self) -> list:
        """The open spans of the calling thread, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s


_STORE = _Store()


class _Span:
    __slots__ = ("name", "uid", "timed", "parent", "t0", "t1", "ev0", "ev1", "_rf")

    def __init__(self, name: str, uid=None, timed: bool = True):
        self.name, self.uid, self.timed = name, uid, timed
        self.parent = self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self):
        stack = _STORE.stack()
        self.parent = stack[-1] if stack else None
        if self.uid is None and self.parent is not None:
            self.uid = self.parent.uid
        self._rf = _profiler.record_function(PREFIX + self.name,
                                             None if self.uid is None else str(self.uid))
        self._rf.__enter__()
        if self.timed:
            self.ev0 = _event()
        self.t0 = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.timed:
            self.ev1 = _event()
        self._rf.__exit__(*exc)
        stack = _STORE.stack()
        if self in stack:
            stack.remove(self)
        _STORE.spans.append(self)
        return False


def span(name: str, uid=None):
    """A span ``saga:<name>``; ``uid`` (default: the enclosing span's) is its
    args in the profiler's trace.  Inside a span of the same name it is
    nothing: the outer one already covers it."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    stack = _STORE.stack()
    if stack and stack[-1].name == name:
        return _OFF
    return _Span(name, uid)


def request(method: str):
    """A span ``saga:request.<method>`` with a fresh request id; inside an
    open request, a span with that request's id and no CUDA events (the
    outer request's cover its device time)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    outer = next((s for s in reversed(_STORE.stack()) if s.name.startswith("request.")), None)
    if outer is not None:
        return _Span("request." + method, outer.uid, timed=False)
    _STORE.requests += 1
    return _Span("request." + method, _STORE.requests)


def sync(site: str, n: int = 1):
    """A span ``saga:sync.<site>`` round ``n`` calls that wait for the device
    (a read back to the host, a copy from pageable host memory), counted as
    ``host_syncs``.  It records no CUDA event: the device is idle by the time
    it ends, and an event there would only lengthen the wait."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    _STORE.counters["host_syncs"] = _STORE.counters.get("host_syncs", 0) + n
    return _Span("sync." + site, timed=False)


def count(name: str, n=1) -> None:
    if not _profiler._is_profiler_enabled:
        return
    _STORE.counters[name] = _STORE.counters.get(name, 0) + int(n)


class _Mark(torch.autograd.Function):
    """Identity forward; the backward records where the gradient reached."""

    @staticmethod
    def forward(ctx, edge, segment, *xs):
        ctx.edge, ctx.segment = edge, segment
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        with _profiler.record_function(PREFIX + "bwd." + ctx.edge):
            _STORE.edges.append((ctx.segment, _event(), time.perf_counter_ns()))
        return (None, None) + grads


def mark(edge: str, segment: str, *tensors):
    """``tensors``, those that need a gradient passed through one mark node
    while tracing is on.  In :func:`backward`, ``segment`` names the backward
    segment that ends when the gradient reaches this edge."""
    if not _profiler._is_profiler_enabled or not torch.is_grad_enabled():
        return tensors
    idx = [i for i, t in enumerate(tensors) if t is not None and t.requires_grad]
    if not idx:
        return tensors
    marked = _Mark.apply(edge, segment, *(tensors[i] for i in idx))
    out = list(tensors)
    for i, m in zip(idx, marked):
        out[i] = m
    return tuple(out)


class _Backward:
    """The span ``saga:backward`` round one backward call; its marks' edges cut
    it into segments ``bwd.<segment>``, the last one ``bwd.<tail>``."""

    __slots__ = ("tail", "span", "ev0", "t0")

    def __init__(self, tail: str):
        self.tail = tail
        self.span = _Span("backward")

    def __enter__(self):
        self.span.__enter__()
        _STORE.edges.clear()
        self.ev0, self.t0 = _event(), time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        cuts = _STORE.edges + [(self.tail, _event(), time.perf_counter_ns())]
        _STORE.edges = []
        ev, t = self.ev0, self.t0
        for segment, ev1, t1 in cuts:
            _STORE.segments.append(("bwd." + segment, ev, ev1, t, t1))
            ev, t = ev1, t1
        return self.span.__exit__(*exc)


def backward(tail: str):
    """Bracket one ``torch.autograd.grad`` call; ``tail`` names the segment
    from the last mark to the end."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Backward(tail)


def _add(entry: dict, host_ns: int, ev0, ev1) -> None:
    """One more span or segment into its name's totals; the device time stays
    None once one of them ran without CUDA events."""
    entry["count"] += 1
    entry["host_ms"] += host_ns * 1e-6
    dev = entry["device_ms"]
    entry["device_ms"] = None if dev is None or ev1 is None else dev + ev0.elapsed_time(ev1)


def summary() -> dict:
    """The window's record::

        {"spans": {name: {"count", "host_ms", "self_host_ms", "device_ms", "uids"}},
         "segments": {name: {"count", "host_ms", "device_ms"}},
         "counters": {name: n},
         "launches": {kernel: launches in the window}}

    ``device_ms`` is None where a span ran without CUDA events (CPU tensors,
    ``saga:sync.*``).  Waits for the device."""
    st = _STORE
    done = [s for s in st.spans if s.t1 is not None]
    if any(s.ev1 is not None for s in done) or any(x[2] is not None for x in st.segments):
        torch.cuda.synchronize()
    child_ns: dict[int, int] = {}
    for s in done:
        if s.parent is not None:
            child_ns[id(s.parent)] = child_ns.get(id(s.parent), 0) + s.t1 - s.t0
    spans: dict[str, dict] = {}
    for s in done:
        e = spans.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                      "device_ms": 0.0, "uids": []})
        _add(e, s.t1 - s.t0, s.ev0, s.ev1)
        e["self_host_ms"] += (s.t1 - s.t0 - child_ns.get(id(s), 0)) * 1e-6
        if s.uid is not None and s.uid not in e["uids"]:
            e["uids"].append(s.uid)
    segments: dict[str, dict] = {}
    for name, ev0, ev1, t0, t1 in st.segments:
        _add(segments.setdefault(name, {"count": 0, "host_ms": 0.0, "device_ms": 0.0}),
             t1 - t0, ev0, ev1)
    launches = {k: v.launches - st.launches0.get(k, 0) for k, v in _kernels().items()}
    return {"spans": spans, "segments": segments, "counters": dict(st.counters),
            "launches": launches}


def reset() -> None:
    """Empty the store (a profiler session's start does it too)."""
    _STORE.reset()


# Every profiler session starts with an empty store.  torch calls this hook
# from both of its profiler classes when recording starts.
_torch_on_start = getattr(_profiler, "_run_on_profiler_start", None)
if _torch_on_start is not None and not getattr(_torch_on_start, "_saga", False):
    def _on_profiler_start():
        _torch_on_start()
        _STORE.reset()

    _on_profiler_start._saga = True
    _profiler._run_on_profiler_start = _on_profiler_start


class ProfileWindow:
    """Profile iterations ``first + 1`` to ``first + count`` of a loop and
    write ``trace.json`` (a Chrome trace: kernels and ``saga:`` spans on one
    clock) and ``spans.json`` (:func:`summary`) into ``out_dir``.  Call
    :meth:`after` with the number of iterations done after each one, outside
    the unit's span, and :meth:`close` when the loop ends."""

    def __init__(self, out_dir: str, first: int = 20, count: int = 10):
        self.out_dir, self.first, self.last = out_dir, first, first + count
        self._prof = None

    def after(self, done: int) -> None:
        if done == self.first and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        elif done == self.last:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
        with open(os.path.join(self.out_dir, "spans.json"), "w") as f:
            json.dump(summary(), f, indent=1)
        print(f"[trace] wrote {self.out_dir}/trace.json and spans.json")
