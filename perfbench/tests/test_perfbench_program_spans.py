"""The readers of the program's own spans and counters (``program_spans.py``).

Every metric whose source is a program span or counter reads a number from a
made-up summary and None from an empty one or from a program without the
tracing module; on the CPU the backward segments carry no device time.

Run: ``python -m pytest perfbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

from perfbench import harness, readers
from perfbench.trace import Trace
from seganygaussians_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m["name"] for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")]

UNITS = 4
MADE_UP = {
    "spans": {"scene_step": {"count": 4, "host_ms": 560.0, "self_host_ms": 3.0,
                             "device_ms": 555.0, "uids": [1, 2, 3, 4]}},
    "segments": {name: {"count": 4, "host_ms": 1.0, "device_ms": 8.0 * (i + 1)}
                 for i, name in enumerate(("bwd.loss", "bwd.raster", "bwd.preprocess",
                                           "bwd.smoothing"))},
    "counters": {"raster.instances": 300, "raster.capacity": 1000, "raster.overflows": 0,
                 "host_syncs": 10},
    "launches": {"blend_fwd": 4, "blend_bwd": 4},
}
EMPTY = {"spans": {}, "segments": {}, "counters": {}, "launches": {}}


def context(units=UNITS):
    trace = Trace(units, 1.0, 0.9, {}, {}, {"device_ops": [], "idle_gaps": []})
    return readers.Context(trace, 0.14, {}, [])


def read(name, ctx):
    return harness.load_file_module(harness.metric_file(ROOT, name)).read(ctx)


def test_the_twelve_metrics_are_listed():
    assert len(PROGRAM) == 12
    for m in BENCH["per_layer"]:
        if m["name"] in PROGRAM:
            assert m["workloads"] and harness.metric_file(ROOT, m["name"]).exists()


@pytest.mark.parametrize("name", PROGRAM)
def test_a_made_up_summary_gives_a_number(name, monkeypatch):
    monkeypatch.setattr(tracing, "summary", lambda: MADE_UP)
    value = read(name, context())
    assert isinstance(value, float) and value > 0
    quantity = name.split(".")[0]
    want = {"loss_bwd_ms": 8.0 / UNITS, "raster_bwd_ms": 16.0 / UNITS,
            "preprocess_bwd_ms": 24.0 / UNITS, "smooth_bwd_ms": 32.0 / UNITS,
            "capacity_use_pct": 30.0, "host_syncs": 10 / UNITS}[quantity]
    assert value == pytest.approx(want)


@pytest.mark.parametrize("name", PROGRAM)
def test_an_empty_summary_gives_none(name, monkeypatch):
    monkeypatch.setattr(tracing, "summary", lambda: EMPTY)
    assert read(name, context()) is None


@pytest.mark.parametrize("name", PROGRAM)
def test_no_tracing_module_gives_none(name, monkeypatch):
    # A program without utils/tracing.py (the parent of the change that
    # brought it): the import fails, the reader says nothing.
    import seganygaussians_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "seganygaussians_torch.utils.tracing", None)
    assert read(name, context()) is None


@pytest.mark.parametrize("name", [n for n in PROGRAM if "_bwd_ms" in n])
def test_cpu_segments_have_no_device_time(name, monkeypatch):
    cpu = json.loads(json.dumps(MADE_UP))
    for seg in cpu["segments"].values():
        seg["device_ms"] = None
    monkeypatch.setattr(tracing, "summary", lambda: cpu)
    assert read(name, context()) is None
