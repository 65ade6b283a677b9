"""The benchmark's import rules, and that it grows by new files only.

Run: ``python -m pytest perfbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import ast
import json
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "seganygaussians_tpu"}


def imported_tops(path: Path) -> set[str]:
    """The top-level name (before the first dot) of every import in a file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_under_perfbench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        assert not imported_tops(path) & FORBIDDEN, path


def test_whole_names_are_compared():
    # The port's name begins with the JAX package's first word: only whole
    # top-level names count.
    tree = ast.parse("import seganygaussians_torch.ops\nfrom jaxtyping import x\n")
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops == {"seganygaussians_torch", "jaxtyping"}
    assert not tops & FORBIDDEN


def test_reference_and_work_import_nothing_of_the_program():
    for sub in ("reference", "work"):
        for path in sorted((BENCH / sub).rglob("*.py")):
            assert "seganygaussians_torch" not in imported_tops(path), path


def _tiny_copy(tmp_path: Path) -> Path:
    """A checkout of the benchmark alone, with the configurations cut to a
    CPU's size (the program is imported from the repository)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(num_gaussians=3000, width=96, height=64, views=4, masks_per_view=6)
        if "feature" in cfg:
            cfg["feature"]["num_sampled_rays"] = 64
        path.write_text(json.dumps(cfg))
    return root


def run_cell(root: Path, workload: str, seed=3, seconds=0.5, trace=0, monkeypatch=None):
    """harness.main on the CPU, in ``root``; returns (rc, result line)."""
    from perfbench import harness

    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)], root=root,
                          started=time.perf_counter(), device=torch.device("cpu"))
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def test_a_new_configuration_mix_and_metric_are_new_files_only(tmp_path):
    root = _tiny_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # A new configuration: a copy of one under another name.
    cfg = json.loads((root / "perfbench/configs/m360_garden.json").read_text())
    cfg["name"] = "dummy_garden"
    (root / "perfbench/configs/dummy_garden.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "dummy_garden", "source": "https://example.org/dummy",
                             "file": "perfbench/configs/dummy_garden.json", "reduced": [],
                             "why": "test"})
    # A new traffic mix of an existing kind: parameters only.
    mix = json.loads((root / "perfbench/traffic/segment.json").read_text())
    mix.update(step_degrees=[10.0, 12.0], views_per_click=1, clicks_per_segment=2, sample=2)
    (root / "perfbench/traffic/dummy_fast_segment.json").write_text(json.dumps(mix))
    (root / "perfbench/limits/dummy_garden.dummy_fast_segment.json").write_text(
        (root / "perfbench/limits/m360_garden.segment.json").read_text())
    cell = "dummy_garden.dummy_fast_segment"
    bench["workloads"].append({"name": cell, "config": "dummy_garden",
                               "traffic": "dummy_fast_segment", "chips": 1, "why": "test"})
    # A new per-layer metric: a reader of its own.
    (root / "perfbench/metrics/dummy_units.serve.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.units)\n")
    bench["per_layer"].append({"name": "dummy_units.serve", "unit": "requests", "better": "higher",
                               "source": "device_trace", "layer": "entry",
                               "moves": "request_ms_p95", "workloads": [cell]})
    # A split of a quantity that has a reader already: no file at all.
    bench["per_layer"].append({"name": "step_mfu.dummy", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "entry",
                               "moves": "request_ms_p95", "workloads": [cell]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "m360_garden.segment" in m["workloads"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (BENCH).rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}

    rc, result = run_cell(root, cell, seconds=2.0, trace=1)
    assert rc == 0
    assert result["metrics"]["dummy_units.serve"]["value"] > 0
    assert result["metrics"]["step_mfu.dummy"]["value"] > 0
    assert result["correct"] is True
    rc, result = run_cell(root, cell, seconds=2.0, trace=0)
    assert rc == 0 and set(result["metrics"]) == {"request_ms_p95", "setup_s"}
    # The repository's benchmark files are untouched.
    assert before == {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
                      and "__pycache__" not in p.parts}


RUNNER = """from perfbench.harness import Outcome


def run(cell):
    out = Outcome()
    cell.setup_done()
    out.attempted = int(cell.mix["units"])
    out.end_to_end["dummy_units_per_s"] = out.attempted / cell.seconds
    out.checks = [("dummy_off", 0.0, 0.0)]
    return out
"""


def test_a_new_kind_of_runner_is_a_new_file(tmp_path, capsys):
    """A mix whose kind is not one of the general runners' is run by
    ``perfbench/runners/<kind>.py``'s ``run``; a kind with no runner at all
    gives no result."""
    root = _tiny_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perfbench/runners").mkdir()
    (root / "perfbench/runners/dummy_count.py").write_text(RUNNER)
    for kind in ("dummy_count", "dummy_missing"):
        (root / f"perfbench/traffic/{kind}.json").write_text(json.dumps({"kind": kind,
                                                                          "units": 5}))
        bench["workloads"].append({"name": f"m360_garden.{kind}", "config": "m360_garden",
                                   "traffic": kind, "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy_units_per_s", "unit": "units/s",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["m360_garden.dummy_count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}

    rc, result = run_cell(root, "m360_garden.dummy_count", seconds=2.0)
    assert rc == 0 and result["correct"] is True and result["attempted"] == 5
    assert result["metrics"]["dummy_units_per_s"]["value"] == 2.5
    assert set(result["metrics"]) == {"dummy_units_per_s", "setup_s"}
    capsys.readouterr()
    rc, result = run_cell(root, "m360_garden.dummy_missing", seconds=2.0)
    assert rc != 0 and result is None
    assert "no runner for the kind 'dummy_missing'" in capsys.readouterr().err
    assert before == {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
                      and "__pycache__" not in p.parts}


def test_no_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/ gives no
    result: the run cannot import the program."""
    root = tmp_path / "bare"
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    import subprocess
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "m360_garden.segment", "--seed", "1", "--seconds", "1"],
                          cwd=root, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
