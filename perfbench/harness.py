"""The benchmark's entry: find a cell by name, run it, print its result.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  A
configuration is ``perfbench/configs/<config>.json``, a traffic mix is
``perfbench/traffic/<traffic>.json`` (its ``kind`` picks one of the general
runners in ``perfbench/cells.py``, or else the runner ``run(cell)`` of
``perfbench/runners/<kind>.py``; the rest are its parameters), a cell's
limits for ``correct`` are ``perfbench/limits/<cell>.json``, and a per-layer
metric ``<quantity>.<split>`` is read by ``perfbench/metrics/<quantity>.<split>.py``
or, where the splits read alike, ``perfbench/metrics/<quantity>.py``: its
``read(ctx)`` returns the value or None.  So a new configuration, mix, cell, metric or
kind of runner is new files and new entries in ``BENCHMARK.json``, never an
edit of a file here.  A runner that cannot run a cell as configured raises
:class:`Refused`: the run prints the reason and no result.

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window run after
the measured one.  The numbers compared for ``correct`` come last on
standard error and last in the result's line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "seganygaussians_tpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class Refused(Exception):
    """The cell's configuration or mix asks for what its runner cannot run."""


class Cell:
    """Everything a runner needs: the cell's entries, its files' contents,
    the run's arguments and the device."""

    def __init__(self, root: Path, bench: dict, workload: dict, args, device, started: float):
        self.root = root
        self.bench = bench
        self.name = workload["name"]
        self.workload = workload
        self.config = json.loads((root / _config_entry(bench, workload["config"])["file"]).read_text())
        self.mix = json.loads((root / "perfbench" / "traffic" / f"{workload['traffic']}.json").read_text())
        limits = root / "perfbench" / "limits" / f"{self.name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.device = device
        self.started = started
        self.setup_s: Optional[float] = None

    def setup_done(self) -> None:
        """Mark the end of set-up: the next thing is the first timed unit."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - self.started
        self.log("set-up done")

    def log(self, what: str) -> None:
        print(f"perfbench: {what} at {time.perf_counter() - self.started:.1f} s", file=sys.stderr,
              flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Outcome:
    """What a runner hands back."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.end_to_end: dict[str, float] = {}
        self.checks: list[tuple[str, float, float]] = []  # (name, value, limit)
        self.memory_peak_bytes = 0
        self.metric_context = None  # readers.Context, in a traced run
        self.readings = None  # the program's and the reference's raw numbers (calibrate.py)


def _config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_file_module(path: Path):
    """A module from a file whose name may hold dots (``metrics/<name>.py``)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_file_{abs(hash(str(path)))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or its per-layer ones."""
    if not trace:
        return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in metrics_of(bench, cell, False)}

    def applies(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in reported

    return [m for m in bench["per_layer"] if applies(m)]


def runner_of(root: Path, kind: str, runners: dict[str, Callable]) -> Callable:
    """The runner of a mix's kind: a general one, else
    ``perfbench/runners/<kind>.py``'s ``run``."""
    if kind in runners:
        return runners[kind]
    path = root / "perfbench" / "runners" / f"{kind}.py"
    if not NAME.fullmatch(kind) or not path.is_file():
        raise Refused(f"no runner for the kind {kind!r}: neither a general one nor {path}")
    return load_file_module(path).run


def metric_file(root: Path, name: str) -> Path:
    """The reader of a per-layer metric: its own file, else its quantity's."""
    own = root / "perfbench" / "metrics" / f"{name}.py"
    return own if own.exists() else own.with_name(f"{name.rsplit('.', 1)[0]}.py")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root, started: float, device: Optional[torch.device] = None,
         runners: Optional[dict[str, Callable]] = None) -> int:
    """Run the cell; 0 with a result line, otherwise no result.  ``device``
    and ``runners`` are for the CPU tests only: a run finds its card itself
    and uses the runners of ``perfbench/cells.py``."""
    args = parse(argv)
    root = Path(root)
    try:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        workload = find_workload(bench, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    if device is None:
        chips = int(workload.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"perfbench: the cell needs {chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        print(f"perfbench: {card_line()}", file=sys.stderr)
    try:
        from perfbench import cells  # imports the program: absent here, no result
    except ImportError as exc:
        print(f"perfbench: cannot import the program: {exc}", file=sys.stderr)
        return 2
    cell = Cell(root, bench, workload, args, device, started)
    try:
        out: Outcome = runner_of(root, cell.mix["kind"], runners or cells.KINDS)(cell)
    except Refused as exc:
        print(f"perfbench: {cell.name} refused: {exc}", file=sys.stderr)
        return 2
    cell.log("reference done")

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3

    metrics = {}
    for m in metrics_of(bench, cell.name, cell.trace):
        if cell.trace:
            value = load_file_module(metric_file(root, m["name"])).read(out.metric_context)
        elif m["name"] == "setup_s":
            value = cell.setup_s
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = {name: {"value": value, "limit": limit} for name, value, limit in out.checks}
    correct = bool(out.checks) and all(
        isinstance(v, float) and math.isfinite(v) and v <= lim for _, v, lim in out.checks)
    devinfo = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": device_kind(device), "count": 1,
               "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": devinfo}
    if cell.trace and out.metric_context is not None:
        ctx = out.metric_context
        devinfo["busy_s"] = ctx.trace.busy_s
        devinfo["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown
    result["checks"] = checks
    for name, value, limit in out.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
